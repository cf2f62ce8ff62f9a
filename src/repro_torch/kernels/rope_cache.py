"""GQA decode's rotary embedding and K / V cache write in one CUDA launch:
the kernel's ctypes binding, the plain version and the launch counter.

``models.layers.apply_attn`` sends a decode step here when :func:`fits`
takes the call: one query token a sequence, plain rope (its own table or
YaRN's), no gradient, plain tensors, bf16 or fp32, an even head dim of at
most 256.  In one launch the kernel (``csrc/rope_cache.cu``) rotates q into
a new tensor, rotates k into ``k_cache[:, slot]`` and copies v into
``v_cache[:, slot]``; the path it replaces issued ~40 small ops a layer
(``layers.rotate`` twice, then two ``write_seq`` copies).  It replaces no
Pallas kernel: the JAX package rotates and writes with plain jnp.  Its
source note gives the design.

The function, at position ``pos`` with ``inv_freq`` [D / 2] (fp32) and
YaRN's cos / sin ``scale`` (1 for plain rope)::

    a = float(pos) * inv_freq;  c = cos(a) * scale;  s = sin(a) * scale
    rot(x) = cat(x1 c - x2 s, x2 c + x1 s)     (x1, x2 the halves of x)

in fp32 from the inputs' dtype, each product and sum rounded on its own,
rounded once to the dtype: exactly ``layers.apply_rope`` and ``write_seq``.

The caller asks :func:`fits` once, then calls :func:`rope_cache`, which
dispatches on where ``q`` lies: on the CPU it computes :func:`plain` (the
replaced ops themselves); on a CUDA device it launches the kernel.  It
never falls back.  Every launch is counted in :data:`launches`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaLibrary

#: Largest head dim the kernel takes (the flash kernels' largest).
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches (one a call) on the card since the last reset.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rope_cache.argtypes = (([ptr] + [i64] * 3) * 3 + ([ptr] + [i64] * 4) * 2
                               + [ptr, ptr] + [i32] * 6
                               + [ctypes.c_float, i32, ptr])
    lib.rope_cache.restype = i32


LIBRARY = CudaLibrary("rope_cache", _bind)


def fits(rope: str, q, k, v, k_cache, v_cache) -> bool:
    """Whether the kernel (or, on the CPU, :func:`plain`) takes a decode
    call: ``rope`` (the config's ``cfg.rope``) plain rope, not M-RoPE or
    none; q [B, 1, Hq, D], k and v [B, 1, Hkv, D], the caches [B, L, Hkv,
    D]; plain tensors (no DTensor or other subclass) of one dtype in
    :data:`DTYPES` on one device, none needing a gradient; D even and at
    most :data:`MAX_HEAD_DIM`."""
    ts = (q, k, v, k_cache, v_cache)
    if rope != "rope" or any(type(t) is not torch.Tensor for t in ts):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return False
    if q.dim() != 4 or k.dim() != 4 or k_cache.dim() != 4:
        return False
    b, s, _hq, d = q.shape
    hkv = k.shape[2]
    dtype, dev = q.dtype, q.device
    return (s == 1 and d % 2 == 0 and 0 < d <= MAX_HEAD_DIM
            and dtype in DTYPES and 1 <= b <= 65535
            and k.shape == v.shape == (b, 1, hkv, d)
            and k_cache.shape == v_cache.shape
            and k_cache.shape[0] == b and k_cache.shape[2:] == (hkv, d)
            and all(t.dtype == dtype and t.device == dev for t in ts[1:]))


def plain(q, k, v, k_cache, v_cache, pos: int, slot: int,
          inv_freq: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The kernel's function on the ops it replaces: ``layers.rope_at``
    (what ``layers.rotate`` runs for plain rope and YaRN) for q and k, then
    ``write_seq`` of k's and v's rows at ``slot``, in place; returns the
    rotated q [B, 1, Hq, D]."""
    from ..distributed.sharding import write_seq
    from ..models.layers import rope_at

    positions = torch.full((q.shape[0], 1), pos, dtype=torch.int64,
                           device=q.device)
    write_seq(k_cache, slot,
              rope_at(k, positions, inv_freq, scale).to(k_cache.dtype))
    write_seq(v_cache, slot, v.to(v_cache.dtype))
    return rope_at(q, positions, inv_freq, scale)


def rope_cache(q, k, v, k_cache, v_cache, pos: int, slot: int,
               inv_freq: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The rotated q [B, 1, Hq, D]; k's rotated row and v's row written at
    ``slot`` of the caches, in place (see the module's docstring).

    The caller has checked the tensors with :func:`fits`, and ``inv_freq``
    / ``scale`` are ``layers._rope_table``'s for q's head dim on q's
    device; only the slot and the position are checked here.  CPU
    tensors: :func:`plain`.  CUDA tensors: one launch on the current stream
    (no synchronisation), counted in :data:`launches`."""
    if not 0 <= slot < k_cache.shape[1] or pos < 0:
        raise ValueError(f"slot {slot} outside the cache's "
                         f"{k_cache.shape[1]} rows, or position {pos} < 0")
    dev = q.device
    if dev.type == "cpu":
        return plain(q, k, v, k_cache, v_cache, pos, slot, inv_freq, scale)
    if dev.type != "cuda":
        raise ValueError(f"rope_cache runs on cpu or cuda, not {dev}")
    if dev.index == torch.cuda.current_device():
        return _launch(q, k, v, k_cache, v_cache, pos, slot, inv_freq, scale)
    with torch.cuda.device(dev.index):
        return _launch(q, k, v, k_cache, v_cache, pos, slot, inv_freq, scale)


def _launch(q, k, v, k_cache, v_cache, pos, slot, inv_freq,
            scale) -> torch.Tensor:
    """The kernel on checked inputs, on their device's current stream;
    counted."""
    global launches
    lib = LIBRARY.load()
    b, _s, hq, d = q.shape
    q_out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    err = lib.rope_cache(
        q.data_ptr(), qs[0], qs[2], qs[3],
        k.data_ptr(), ks[0], ks[2], ks[3],
        v.data_ptr(), vs[0], vs[2], vs[3],
        k_cache.data_ptr(), *k_cache.stride(),
        v_cache.data_ptr(), *v_cache.stride(),
        q_out.data_ptr(), inv_freq.data_ptr(),
        b, hq, k.shape[2], d, pos, slot, scale,
        int(q.dtype == torch.bfloat16),
        torch._C._cuda_getCurrentRawStream(q.device.index))
    if err != 0:
        why = "arguments refused" if err == 1001 else f"cudaError {err}"
        raise RuntimeError(f"rope_cache launch failed: {why}")
    launches += 1
    return q_out
