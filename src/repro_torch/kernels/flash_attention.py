"""Streaming (flash) softmax attention: three CUDA routes for Hopper, their
ctypes bindings, the route planner and the launch counters.

The serving path spends its attention time here: every layer of a prefill
and of each decode step.  Each route replaces the Pallas TPU kernel
``_flash_kernel`` of ``src/repro/kernels/flash_attention.py`` for the calls
:func:`plan` gives it; each source's note gives its design and bound:

``wgmma``    bf16 prefill at every head dim (``csrc/flash_prefill_sm90.cu``:
             TMA, mbarriers, warp-specialised ``wgmma``; D 80 and 96 on a
             tile padded to 128 columns, D 192 and 256 on 64-key tiles);
``splitkv``  bf16 calls with at most 64 query rows per KV head -- decode
             steps (``csrc/flash_decode_splitkv.cu``: split-KV over the card,
             then a merge in split order);
``simt``     float32 (``csrc/flash_attention.cu``: products on the CUDA cores
             in fp32, K/V double-buffered by ``cp.async``, a block's warps
             splitting the keys and merging in order).

Every route takes head dims 64, 80, 96, 128, 192 and 256, a causal mask at
a query offset, a sliding window (key ``kpos`` is live for the query at
``qpos`` only if ``kpos > qpos - window``, the reference ``_sdpa``'s mask)
and an explicit key count ``kv_len`` (keys ``[0, kv_len)`` are live, the
Pallas kernel's own ``kv_len``).  The libraries are built by
:mod:`repro_torch.kernels.build` (``nvcc`` for ``sm_90a`` at first use,
into ``build/``).

:func:`flash_attention_bshd` dispatches on where its tensors lie: on the CPU
it computes the plain PyTorch version (:func:`plain`, through
:func:`repro_torch.kernels.ref.mha_ref`); on a CUDA device it launches the
planned route or raises.  The route comes from shape and dtype, never from a
failure: no route falls back to another or to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import ref
from .build import CudaLibrary

#: Head dims the kernels are compiled for (``D`` is a template parameter).
HEAD_DIMS = (64, 80, 96, 128, 192, 256)
DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("wgmma", "splitkv", "simt")
#: Head dims of the ``wgmma`` prefill route (80 and 96 padded to 128; 192
#: and 256 on 64-key tiles).
WGMMA_HEAD_DIMS = (64, 80, 96, 128, 192, 256)
#: Most query rows (``Sq * group``) a ``splitkv`` block holds.
DECODE_MAX_ROWS = 64
#: Keys per ``splitkv`` tile; splits are whole tiles.
DECODE_TILE = 64
#: Most tiles one ``splitkv`` block streams.
DECODE_MAX_TILES = 4
#: SMs of an H100 SXM: the planner's default when no card is asked.
H100_SMS = 132

_PTRS = [ctypes.c_void_p] * 4
_STRIDES = [ctypes.c_longlong] * 12


def _bind_simt(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = (
        _PTRS + [ctypes.c_int] * 5 + _STRIDES
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int


def _bind_wgmma(lib: ctypes.CDLL) -> None:
    lib.flash_prefill.argtypes = (
        _PTRS + [ctypes.c_int] * 5 + _STRIDES
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_prefill.restype = ctypes.c_int


def _bind_splitkv(lib: ctypes.CDLL) -> None:
    lib.flash_decode.argtypes = (
        _PTRS + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + _STRIDES
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_decode.restype = ctypes.c_int


#: Each route's library, built from ``csrc/<name>.cu``.
LIBRARIES = {
    "wgmma": CudaLibrary("flash_prefill_sm90", _bind_wgmma),
    "splitkv": CudaLibrary("flash_decode_splitkv", _bind_splitkv),
    "simt": CudaLibrary("flash_attention", _bind_simt),
}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def plain(q, k, v, causal: bool, q_offset: int = 0,
          scale: float | None = None, window: int | None = None,
          kv_len: int | None = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch, in their layout:
    ``[B, Sq, Hq, D]`` against ``[B, Skv, Hkv, D]``, KV heads repeated to
    the query heads (head ``h`` reads KV head ``h // group``).  ``scale``
    multiplies the logits (default ``D**-0.5``); ``window`` and ``kv_len``
    mask keys as :func:`ref.mha_ref` does."""
    group = q.shape[2] // k.shape[2]

    def bhsd(x):
        return x.transpose(1, 2)

    out = ref.mha_ref(bhsd(q), bhsd(k.repeat_interleave(group, dim=2)),
                      bhsd(v.repeat_interleave(group, dim=2)),
                      causal=causal, scale=scale, q_offset=q_offset,
                      window=window, kv_len=kv_len)
    return bhsd(out)


def live_range(sq: int, skv: int, causal: bool, q_offset: int,
               window: int | None = None, kv_len: int | None = None) -> tuple:
    """``(lo, hi)``: the keys some query row may attend.  ``hi`` is
    ``kv_len`` (default ``Skv``), cut to ``q_offset + Sq`` when causal (a
    causal decode step's is its position + 1, not the cache's length);
    ``lo`` is 0, or with a window the least key the first row's window
    holds."""
    hi = skv if kv_len is None else max(0, min(skv, kv_len))
    if causal:
        hi = max(0, min(hi, q_offset + sq))
    lo = 0 if window is None else max(0, q_offset - window + 1)
    return min(lo, hi), hi


def _split_shape(n_live: int, splits: int, lo: int = 0) -> tuple:
    """``(splits, tiles per split)`` once the keys ``[lo, n_live)``, from
    ``lo``'s 64-key tile on, are cut into at most ``splits`` runs of whole
    tiles, none empty."""
    tiles = -(-n_live // DECODE_TILE) - lo // DECODE_TILE
    if tiles <= 0:
        return 1, 1
    per = -(-tiles // max(1, splits))
    return -(-tiles // per), per


def split_ranges(n_live: int, splits: int, lo: int = 0) -> list:
    """Key ranges of the ``splitkv`` route: the keys ``[lo, n_live)`` cut
    into at most ``splits`` runs of whole 64-key tiles from ``lo``'s tile
    on, none empty (the first may start below ``lo``: the window masks
    those keys)."""
    n, per = _split_shape(n_live, splits, lo)
    base = lo // DECODE_TILE * DECODE_TILE
    step = per * DECODE_TILE
    return [(base + i * step, min(base + (i + 1) * step, n_live))
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def softmax_scale(d: int) -> float:
    """d**-0.5 in float32, as the TPU wrapper forms it."""
    return float(torch.tensor(d, dtype=torch.float32) ** -0.5)


def plain_split_kv(q, k, v, causal: bool, q_offset: int, splits: int,
                   window: int | None = None,
                   kv_len: int | None = None) -> torch.Tensor:
    """The ``splitkv`` route's arithmetic in plain PyTorch: q pre-scaled by
    ``d**-0.5`` and rounded to its dtype, a partial ``(m, l, acc)`` in fp32
    per key range of :func:`split_ranges` over :func:`live_range`, then the
    merge in split order.  Same layout and result as :func:`plain`."""
    b, sq, hq, d = q.shape
    group = hq // k.shape[2]
    qs = (q.float() * softmax_scale(d)).to(q.dtype).float()
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    first, n_live = live_range(sq, k.shape[1], causal, q_offset, window,
                               kv_len)
    qpos = q_offset + torch.arange(sq, device=q.device)
    parts = []
    for lo, hi in split_ranges(n_live, splits, first):
        logits = torch.einsum("bqhd,bkhd->bhqk", qs, kf[:, lo:hi])
        kpos = torch.arange(lo, hi, device=q.device)
        dead = torch.zeros((sq, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            dead |= kpos[None, :] > qpos[:, None]
        if window is not None:
            dead |= kpos[None, :] <= qpos[:, None] - window
        logits = logits.masked_fill(dead, float("-inf"))
        m = logits.amax(dim=-1, keepdim=True) if hi > lo else \
            logits.new_full(logits.shape[:-1] + (1,), float("-inf"))
        p = torch.exp(logits - torch.nan_to_num(m, neginf=0.0))
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bhqk,bkhd->bhqd", p, vf[:, lo:hi])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    m_all = torch.nan_to_num(m_all, neginf=0.0)
    den = torch.zeros_like(parts[0][1])
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:                       # split order
        w = torch.exp(m - m_all)
        den = den + l * w
        num = num + acc * w
    return (num / den.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# The route planner
# ---------------------------------------------------------------------------

def decode_splits(bh: int, n_live: int, sms: int = H100_SMS,
                  lo: int = 0) -> int:
    """Splits of the live keys ``[lo, n_live)`` so the ``splitkv`` grid has
    at least two blocks per SM (``bh`` = batch x KV heads) and each block
    at most :data:`DECODE_MAX_TILES` tiles, so a long cache keeps many loads
    in flight; each split a run of whole tiles, none empty."""
    tiles = -(-n_live // DECODE_TILE) - lo // DECODE_TILE
    want = max(-(-2 * sms // bh), -(-tiles // DECODE_MAX_TILES))
    return _split_shape(n_live, min(tiles, want), lo)[0]


def plan(q, k, causal: bool = True, q_offset: int = 0,
         sms: int = H100_SMS, window: int | None = None,
         kv_len: int | None = None) -> tuple:
    """``(route, splits)`` for a call, from shape and dtype alone:

    - float32 -> ``simt``;
    - bf16 with ``Sq * group <= 64`` -> ``splitkv``, over the live keys of
      :func:`live_range`;
    - every other bf16 call -> ``wgmma`` (every head dim, causal or not).

    ``splits`` is 1 except for ``splitkv``.  Works on shapes only, so the
    CPU tests check it."""
    b, sq, hq, _d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16:
        return "simt", 1
    if sq * (hq // hkv) <= DECODE_MAX_ROWS:
        lo, hi = live_range(sq, skv, causal, q_offset, window, kv_len)
        return "splitkv", decode_splits(b * hkv, hi, sms, lo)
    return "wgmma", 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _check_mask(window, kv_len) -> None:
    """Raise unless ``window`` is None or a positive key count and
    ``kv_len`` None or a key count."""
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window must be a positive key count, not {window}")
    if kv_len is not None and (int(kv_len) != kv_len or kv_len < 0):
        raise ValueError(f"kv_len must be a key count >= 0, not {kv_len}")


def _check(q, k, v) -> None:
    """Raise unless the kernels take these tensors: ``[B, S, H, D]`` with
    the head dim contiguous, one dtype and device, ``Hq`` a multiple of
    ``Hkv``, ``D`` in :data:`HEAD_DIMS`."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    b, _sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name} is {t.dtype}; want one of {DTYPES}, "
                            "the same for q, k and v")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    if b * k.shape[2] > 65535:
        raise ValueError("batch x KV heads exceeds the kernel's grid")


def _check_route(route: str, q, k) -> None:
    """Raise unless ``route`` takes these inputs: ``simt`` float32, the
    others bf16.  Every route reads rows by TMA or 16-byte loads (see
    :func:`_check_alignment`)."""
    if route not in ROUTES:
        raise ValueError(f"unknown flash route {route!r}; have {ROUTES}")
    b, sq, hq, d = q.shape
    group = hq // k.shape[2]
    want = torch.float32 if route == "simt" else torch.bfloat16
    if q.dtype != want:
        raise TypeError(f"the {route} route takes {want}, not {q.dtype}")
    if route == "wgmma" and (d not in WGMMA_HEAD_DIMS or group > 128):
        raise ValueError(f"the wgmma route takes head dims {WGMMA_HEAD_DIMS} "
                         f"and query groups of at most 128, not D={d}, "
                         f"group={group}")
    if route == "splitkv" and sq * group > DECODE_MAX_ROWS:
        raise ValueError(f"the splitkv route holds at most {DECODE_MAX_ROWS} "
                         f"query rows per KV head, not {sq} x {group}")


def _check_alignment(route: str, tensors: dict) -> None:
    for name, t in tensors.items():
        item = t.element_size()
        sb, ss, sh, _ = t.stride()
        if (t.data_ptr() | (sb | ss | sh) * item) & 15:
            raise ValueError(
                f"the {route} route reads {name} by TMA / 16-byte loads: it "
                "needs a 16-byte aligned base address and batch, position and "
                f"head strides that are multiples of 16 bytes; {name} has "
                f"strides {tuple(t.stride())} of {item}-byte elements at "
                f"address {t.data_ptr():#x}")


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def flash_attention_bshd(q, k, v, causal: bool = True, q_offset: int = 0,
                         scale: float | None = None,
                         window: int | None = None,
                         kv_len: int | None = None) -> torch.Tensor:
    """Softmax attention, ``[B, Sq, Hq, D]`` queries against
    ``[B, Skv, Hkv, D]`` keys and values -> ``[B, Sq, Hq, D]`` in q's dtype.

    ``q_offset`` places query row ``i`` at position ``q_offset + i`` of the
    KV timeline for the causal mask and the window (0 for prefill, the
    cache position for decode).  ``scale`` multiplies the logits (default
    ``D**-0.5``; a caller that zero-pads ``D`` passes the true one's).
    ``window`` keeps, for the query at ``qpos``, the keys ``kpos > qpos -
    window``; ``kv_len`` the keys ``[0, kv_len)`` (default ``Skv``).  A row
    with no live key gives zeros.  CPU tensors: :func:`plain`.  CUDA
    tensors: the route and splits of :func:`plan`, launched by
    :func:`_launch`.
    """
    _check_mask(window, kv_len)
    if q.device.type == "cpu":
        return plain(q, k, v, causal, q_offset, scale, window, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    route, splits = plan(q, k, causal, q_offset,
                         sms=_sm_count(q.device.index or 0), window=window,
                         kv_len=kv_len)
    return _launch(route, q, k, v, causal, q_offset, splits, scale, window,
                   kv_len)


def _launch(route: str, q, k, v, causal: bool, q_offset: int,
            splits: int, scale: float | None = None,
            window: int | None = None,
            kv_len: int | None = None) -> torch.Tensor:
    """Launch ``route`` on CUDA tensors that :func:`_check` passed, on the
    current stream without synchronisation; ``splits`` is the ``splitkv``
    route's (the others ignore it), ``scale`` the logits' factor (default
    :func:`softmax_scale` of ``D``), ``window`` and ``kv_len`` the masks of
    :func:`flash_attention_bshd`.  Raises unless the route takes the
    inputs.  Counts the launch in ``flash_attention_bshd.launches`` and
    ``flash_attention_bshd.route_launches[route]``.  The entry point calls
    it with :func:`plan`'s choice; the card tests and the timing script
    call it to force a route."""
    _check_mask(window, kv_len)
    _check_route(route, q, k)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _check_alignment(route, {"q": q, "k": k, "v": v})
    lib = LIBRARIES[route].load()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    scale = softmax_scale(d) if scale is None else float(scale)
    lo, n_live = live_range(sq, skv, causal, q_offset, window, kv_len)
    win = 0 if window is None else int(window)
    with _on(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            err = lib.flash_prefill(*ptrs, b, sq, hq, hkv, d, *strides,
                                    int(causal), int(q_offset), n_live, win,
                                    scale, stream)
        elif route == "splitkv":
            n_split, per = _split_shape(n_live, splits, lo)
            # Scratch for the partials: acc [splits, B*Hkv, rows, D], then
            # (m, l) [splits, B*Hkv, rows, 2], fp32, in one allocation.
            n_acc = n_split * b * hkv * sq * (hq // hkv) * d
            part = torch.empty(n_acc + 2 * n_acc // d, dtype=torch.float32,
                               device=q.device)
            err = lib.flash_decode(*ptrs, part.data_ptr(),
                                   part.data_ptr() + 4 * n_acc,
                                   b, sq, hq, hkv, d,
                                   *strides, int(causal), int(q_offset),
                                   n_live, n_split, per, lo // DECODE_TILE,
                                   win, scale, stream)
        else:
            kv_hi = skv if kv_len is None else max(0, min(skv, kv_len))
            err = lib.flash_attention(
                *ptrs, b, sq, hq, hkv, d, *strides, int(causal),
                int(q_offset), kv_hi, win, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash attention ({route} route) failed to launch: "
                           f"{_describe(err)}")
    flash_attention_bshd.launches += 1
    flash_attention_bshd.route_launches[route] += 1
    return out


def _on(device):
    """The device's context, entered only when it is not current (entering
    costs microseconds a call on the decode path)."""
    if (device.index or 0) == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _describe(err: int) -> str:
    if err == 1001:
        return "the CUDA entry point cuTensorMapEncodeTiled was not found"
    if err == 1002:
        return "cuTensorMapEncodeTiled refused a TMA tensor map for q, k or v"
    return f"cudaError {err}"


def reset_launches() -> None:
    """Set the total and every route's launch count to 0."""
    flash_attention_bshd.launches = 0
    flash_attention_bshd.route_launches = dict.fromkeys(ROUTES, 0)


flash_attention_bshd.launches = 0
flash_attention_bshd.route_launches = dict.fromkeys(ROUTES, 0)
