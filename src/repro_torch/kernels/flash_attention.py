"""Streaming (flash) softmax attention: the CUDA kernel for Hopper, its
ctypes binding and its launch counter.

The serving path spends its attention time here: every layer of a prefill
and of each decode step.  The kernel (``csrc/flash_attention.cu``) replaces
the Pallas TPU kernel ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py``; its source note gives the design
and the bound.  The library is built by :mod:`repro_torch.kernels.build`
(``nvcc`` for ``sm_90a`` at first use, into ``build/``).

:func:`flash_attention_bshd` dispatches on where its tensors lie: on the CPU
it computes the plain PyTorch version (:func:`plain`, through
:func:`repro_torch.kernels.ref.mha_ref`); on a CUDA device it launches the
kernel or raises.  It never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import CudaLibrary

#: Head dims the kernel is compiled for (``D`` is a template parameter).
HEAD_DIMS = (64, 80, 96, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention", _bind)


def plain(q, k, v, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's layout:
    ``[B, Sq, Hq, D]`` against ``[B, Skv, Hkv, D]``, KV heads repeated to
    the query heads (head ``h`` reads KV head ``h // group``)."""
    group = q.shape[2] // k.shape[2]

    def bhsd(x):
        return x.transpose(1, 2)

    out = ref.mha_ref(bhsd(q), bhsd(k.repeat_interleave(group, dim=2)),
                      bhsd(v.repeat_interleave(group, dim=2)),
                      causal=causal, q_offset=q_offset)
    return bhsd(out)


def _check(q, k, v) -> None:
    """Raise unless the kernel takes these tensors: ``[B, S, H, D]`` with
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


def flash_attention_bshd(q, k, v, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """Softmax attention, ``[B, Sq, Hq, D]`` queries against
    ``[B, Skv, Hkv, D]`` keys and values -> ``[B, Sq, Hq, D]`` in q's dtype.

    ``q_offset`` places query row ``i`` at position ``q_offset + i`` of the
    KV timeline for the causal mask (0 for prefill, the cache position for
    decode).  CPU tensors: :func:`plain`.  CUDA tensors: one launch on the
    current stream (no synchronisation), counted in
    ``flash_attention_bshd.launches``.
    """
    if q.device.type == "cpu":
        return plain(q, k, v, causal, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    lib = LIBRARY.load()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # d**-0.5 in float32, as the TPU wrapper forms it.
    scale = float(torch.tensor(d, dtype=torch.float32) ** -0.5)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, sq, hq, hkv, d, *strides,
            int(causal), int(q_offset), skv, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with cudaError {err}")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0
