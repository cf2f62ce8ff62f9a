"""MLA decode over the latent cache: two CUDA kernels for Hopper, their
ctypes binding, the plain version and the launch counter.

``models.layers.apply_mla`` sends a decode step to :func:`mla_decode` when
no gradient is needed, the tensors are plain and :func:`fits` takes the
shapes: one query token a sequence, at most 16 heads, DeepSeek-V2's latent
widths (R 512, rope 64), bf16; every other decode step to :func:`plain`.
The kernels (``csrc/mla_decode.cu``) replace the
absorbed decode of the JAX package's ``apply_mla``, plain jnp that reads
and converts the whole ``max_len`` cache to fp32 every step; their source
note gives the design and the byte bound.

The function, for each sequence ``b`` and head ``h`` with the absorbed
query ``q_lat = q_nope w_uk`` [R] and the rotated ``q_rope`` [Dr], against
the cache rows ``t < kv_len``::

    s_t = scale * (q_lat . ckv_t + q_rope . krope_t)
    o   = sum_t softmax(s)_t ckv_t                         [R]

products and softmax in fp32, ``o`` in the queries' dtype.  Each latent
row is read once for all heads.  The kernels round ``p`` to bf16 before
``p . ckv`` and keep the softmax online over 32-key tiles; :func:`plain`
rounds the normalised ``p`` to the cache's dtype.  Both read no row at or
past ``kv_len``.

:func:`mla_decode` dispatches on where the queries lie: on the CPU it
computes :func:`plain`; on a CUDA device it launches both kernels or
raises.  It never falls back.  Every launch is counted in
:data:`launches`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .build import CudaLibrary

#: Latent and rope widths the kernels are compiled for (DeepSeek-V2's).
LATENT = 512
ROPE = 64
#: Most heads a call may have (the tensor cores' 16 rows).
MAX_HEADS = 16
#: Keys a tile of the split kernel.
TILE = 32
#: Blocks a call aims at, per SM (one fits an SM: one wave).
BLOCKS_PER_SM = 1

#: Kernel launches (two a call) on the card since the last reset.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mla_decode.argtypes = ([ptr, i64, i64] * 2 + [ptr, i64, i64] * 2
                               + [ptr] * 3 + [i32] * 5 + [ctypes.c_float, ptr])
    lib.mla_decode.restype = i32


LIBRARY = CudaLibrary("mla_decode", _bind)


def _rows_ok(t: torch.Tensor) -> bool:
    """Last axis contiguous, every row 16-byte aligned (bf16)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1]))


def fits(b: int, s: int, h: int, ckv: torch.Tensor, krope: torch.Tensor,
         dtype: torch.dtype) -> bool:
    """Whether the kernels take a decode call of ``b`` sequences of ``s``
    query tokens and ``h`` heads against the caches ``ckv`` [B, T, R] and
    ``krope`` [B, T, Dr] in ``dtype``: one token, 1..16 heads, R 512,
    Dr 64, bf16 throughout, rows the kernels can load.  The plain version
    follows the same rule, so the CPU and the card take the same path."""
    return (s == 1 and 1 <= h <= MAX_HEADS and 1 <= b <= 65535
            and dtype == torch.bfloat16
            and ckv.dim() == 3 and krope.dim() == 3
            and ckv.shape[-1] == LATENT and krope.shape[-1] == ROPE
            and ckv.shape[:2] == krope.shape[:2] and ckv.shape[0] == b
            and ckv.dtype == krope.dtype == dtype
            and _rows_ok(ckv) and _rows_ok(krope))


def plain(q_lat, q_rope, ckv, krope, kv_len: int, scale: float) -> torch.Tensor:
    """The kernels' function in plain PyTorch: ``q_lat`` [B, 1, H, R],
    ``q_rope`` [B, 1, H, Dr], caches [B, T, R] / [B, T, Dr]; the scores and
    softmax in fp32 over the first ``kv_len`` rows, the probabilities
    rounded to the cache's dtype, ``o`` [B, 1, H, R] in ``q_lat``'s
    dtype."""
    c = ckv[:, :kv_len].float()
    s = (torch.einsum("bshr,btr->bhst", q_lat.float(), c)
         + torch.einsum("bshk,btk->bhst", q_rope.float(),
                        krope[:, :kv_len].float())) * scale
    p = torch.softmax(s, dim=-1).to(ckv.dtype).float()
    return torch.einsum("bhst,btr->bshr", p, c).to(q_lat.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(b: int, kv_len: int, sms: int):
    """(splits, tiles a split) of a call: about :data:`BLOCKS_PER_SM`
    blocks an SM over ``b`` sequences, every split a run of whole
    :data:`TILE`-key tiles and none empty."""
    tiles = -(-kv_len // TILE)
    want = max(1, min(tiles, -(-BLOCKS_PER_SM * sms // b)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def _check(q_lat, q_rope, ckv, krope, kv_len: int) -> None:
    """Raise unless the kernels take these tensors (see :func:`fits`)."""
    if q_lat.dim() != 4 or q_rope.dim() != 4:
        raise ValueError(f"want q_lat [B, 1, H, R], q_rope [B, 1, H, Dr]; got "
                         f"{tuple(q_lat.shape)}, {tuple(q_rope.shape)}")
    b, s, h, _r = q_lat.shape
    if not fits(b, s, h, ckv, krope, q_lat.dtype):
        raise ValueError(
            f"the kernels do not take B={b}, S={s}, H={h}, ckv "
            f"{tuple(ckv.shape)} {ckv.dtype}, krope {tuple(krope.shape)} in "
            f"{q_lat.dtype} (see mla_decode.fits)")
    if q_lat.shape != (b, 1, h, LATENT) or q_rope.shape != (b, 1, h, ROPE):
        raise ValueError(f"q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)} do not match B={b}, H={h}")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("ckv", ckv),
                    ("krope", krope)):
        if t.dtype != q_lat.dtype or t.device != q_lat.device or not _rows_ok(t):
            raise ValueError(f"{name} is {t.dtype} on {t.device} at strides "
                             f"{t.stride()}; want {q_lat.dtype} on "
                             f"{q_lat.device}, rows contiguous and 16-byte "
                             "aligned")
    if not 1 <= kv_len <= ckv.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {ckv.shape[1]}]")


def mla_decode(q_lat, q_rope, ckv, krope, kv_len: int,
               scale: float) -> torch.Tensor:
    """``o_lat`` [B, 1, H, R] in ``q_lat``'s dtype (see the module's
    docstring); queries whose rows the kernels cannot load are copied
    first.

    CPU tensors: :func:`plain`.  CUDA tensors: the two kernels on the
    current stream (no synchronisation), counted in :data:`launches`."""
    if q_lat.device.type == "cpu":
        return plain(q_lat, q_rope, ckv, krope, kv_len, scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_decode runs on cpu or cuda, not {q_lat.device}")
    q_lat = q_lat if _rows_ok(q_lat) else q_lat.contiguous()
    q_rope = q_rope if _rows_ok(q_rope) else q_rope.contiguous()
    _check(q_lat, q_rope, ckv, krope, kv_len)
    index = q_lat.device.index
    current = index is None or index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(index):
        splits, per = split_plan(q_lat.shape[0], kv_len,
                                 _sm_count(torch.cuda.current_device()))
        return _launch(q_lat, q_rope, ckv, krope, kv_len, scale, splits, per)


def _launch(q_lat, q_rope, ckv, krope, kv_len: int, scale: float,
            splits: int, per: int) -> torch.Tensor:
    """Both kernels on checked inputs, ``splits`` splits of ``per`` tiles
    each; counted.  Card tests force a split plan through it."""
    global launches
    lib = LIBRARY.load()
    b, _s, h, _r = q_lat.shape
    dev = q_lat.device
    o_part = torch.empty((b, splits, h, LATENT), dtype=torch.float32, device=dev)
    lse = torch.empty((b, splits, h), dtype=torch.float32, device=dev)
    out = torch.empty((b, 1, h, LATENT), dtype=q_lat.dtype, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.mla_decode(
        q_lat.data_ptr(), q_lat.stride(0), q_lat.stride(2),
        q_rope.data_ptr(), q_rope.stride(0), q_rope.stride(2),
        ckv.data_ptr(), ckv.stride(0), ckv.stride(1),
        krope.data_ptr(), krope.stride(0), krope.stride(1),
        o_part.data_ptr(), lse.data_ptr(), out.data_ptr(),
        b, h, kv_len, splits, per, float(scale), stream)
    if err != 0:
        why = "arguments refused" if err == 1001 else f"cudaError {err}"
        raise RuntimeError(f"mla_decode launch failed: {why}")
    launches += 2
    return out
