"""Batched ExpectedCost(TTL) scan and TTL decision (paper §3.2.2): the CUDA
kernel for Hopper, its build, its ctypes binding and its launch counter.

The metadata server periodically recomputes, for every (bucket x directed
edge) pair, the expected cost of all ~800 candidate TTLs and takes the argmin
(§6.7.3: regions x buckets x incoming edges = ~100k edge problems per
refresh).  The kernel (``csrc/ttl_scan.cu``) replaces the Pallas TPU kernel
``_ttl_scan_kernel`` of ``src/repro/kernels/ttl_scan.py`` and the TTL = 0
column and argmin around it; its source note gives the design and the bound
(16 bytes a cell with the surface, 12 without).

The library is built by :mod:`repro_torch.kernels.build` (``nvcc`` for
``sm_90a`` at first use, into ``build/``); nothing is compiled or loaded at
import.

:func:`ttl_cost_surface` and :func:`ttl_decision` dispatch on where their
tensors lie: on the CPU they compute the plain PyTorch version
(:mod:`repro_torch.kernels.ref`); on a CUDA device they launch the kernel or
raise.  They never fall back.  Every launch of the library, from these or
from the refresh path of :mod:`repro_torch.kernels.ops`, goes through
:func:`_launch` and is counted in ``ttl_cost_surface.launches``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import ref
from .build import CudaLibrary

#: The most cells a row may have: one block of 1,024 threads, 4 cells each.
MAX_CELLS = 4096


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ttl_scan.argtypes = ([ptr] * 3 + [ctypes.c_longlong] + [ptr] * 8
                             + [i32, i32, ptr])
    lib.ttl_scan.restype = ctypes.c_int


LIBRARY = CudaLibrary("ttl_scan", _bind)


def _row_stride(t: torch.Tensor, name: str) -> int:
    """Elements between rows: C for a contiguous [E, C] tensor, 0 for one
    row expanded to E rows (``row[None].expand(E, C)``)."""
    if t.is_contiguous():
        return t.shape[1]
    if t.stride() == (0, 1):
        return 0
    raise ValueError(f"{name} must be contiguous, or one contiguous row "
                     f"expanded to every row (strides {t.stride()})")


def _check(hist, time_w, last, edges, s_price, n_price, first_remote) -> int:
    """Check what the kernel takes; return the row stride of the inputs."""
    if hist.dim() != 2:
        raise ValueError(f"hist must be [E, C], got shape {tuple(hist.shape)}")
    e_dim, c_dim = hist.shape
    want = {"hist": (e_dim, c_dim), "time_w": (e_dim, c_dim),
            "last": (e_dim, c_dim), "edges": (c_dim,), "s_price": (e_dim,),
            "n_price": (e_dim,), "first_remote": (e_dim,)}
    got = dict(zip(want, (hist, time_w, last, edges, s_price, n_price,
                          first_remote)))
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"want {want[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != hist.device:
            raise ValueError(f"{name} is on {t.device}, hist on {hist.device}")
        if t.dim() == 1 and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    strides = {_row_stride(t, name) for name, t in
               (("hist", hist), ("time_w", time_w), ("last", last))}
    if len(strides) != 1:
        raise ValueError("hist, time_w and last must share one row layout")
    if not 1 <= c_dim <= MAX_CELLS or e_dim * c_dim >= 2**31:
        raise ValueError(f"unsupported problem size E={e_dim}, C={c_dim} "
                         f"(1 <= C <= {MAX_CELLS})")
    return strides.pop()


def _launch(device: torch.device, hist: int, time_w: int, last: int,
            row_stride: int, edges: int, s_price: int, n_price: int,
            first_remote: int, cost: int | None, best_idx: int | None,
            best_cost: int | None, zero_cost: int | None, e_dim: int,
            c_dim: int) -> None:
    """One launch on ``device``'s current stream, by data pointers (ints;
    None for an output not asked for); counted, not synchronised."""
    lib = LIBRARY.load()
    # Entering torch.cuda.device costs a refresh a large share of its host
    # time; it is needed only when the device is not the current one.
    current = device.index is None or device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ttl_scan(hist, time_w, last, row_stride, edges, s_price,
                           n_price, first_remote, cost, best_idx, best_cost,
                           zero_cost, e_dim, c_dim, stream)
    if err != 0:
        raise RuntimeError(f"ttl_scan launch failed with cudaError {err}")
    ttl_cost_surface.launches += 1


def _on_card(name: str, hist: torch.Tensor) -> None:
    if hist.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {hist.device}")


def ttl_cost_surface(
    hist: torch.Tensor,          # [E, C] float32 (rows contiguous, stride C or 0)
    time_w: torch.Tensor,        # [E, C]
    last: torch.Tensor,          # [E, C]
    edges: torch.Tensor,         # [C]
    s_price: torch.Tensor,       # [E]  $ / byte-second
    n_price: torch.Tensor,       # [E]  $ / byte
    first_remote: torch.Tensor,  # [E]
) -> torch.Tensor:
    """[E, C] float32 expected-cost surface.

    CPU tensors: the plain version.  CUDA tensors: one launch of the kernel on
    the current stream (no synchronisation), counted in
    ``ttl_cost_surface.launches``.
    """
    if hist.device.type == "cpu":
        return ref.ttl_cost_ref(hist, time_w, last, edges, s_price, n_price,
                                first_remote)
    _on_card("ttl_cost_surface", hist)
    stride = _check(hist, time_w, last, edges, s_price, n_price, first_remote)
    e_dim, c_dim = hist.shape
    out = torch.empty((e_dim, c_dim), dtype=torch.float32, device=hist.device)
    if e_dim:
        _launch(hist.device, hist.data_ptr(), time_w.data_ptr(),
                last.data_ptr(), stride, edges.data_ptr(), s_price.data_ptr(),
                n_price.data_ptr(), first_remote.data_ptr(), out.data_ptr(),
                None, None, None, e_dim, c_dim)
    return out


ttl_cost_surface.launches = 0


def ttl_decision(hist, time_w, last, edges, s_price, n_price, first_remote,
                 surface: bool = False):
    """The TTL decision of every row: ``(idx [E] int32, best [E] float32,
    zero [E] float32, surface [E, C] float32 or None)``.

    ``idx`` indexes the candidates ``[TTL = 0, edges...]`` by
    :func:`repro_torch.kernels.ref.canonical_argmin` of ``[zero, surface]``;
    ``best`` is the cost there and ``zero`` the TTL = 0 cost.  CPU tensors:
    the plain version (:func:`repro_torch.kernels.ref.ttl_decision_ref`).
    CUDA tensors: one launch, as :func:`ttl_cost_surface`; the surface is
    stored only when ``surface`` is true.
    """
    if hist.device.type == "cpu":
        idx, best, zero, surf = ref.ttl_decision_ref(
            hist, time_w, last, edges, s_price, n_price, first_remote)
        return idx.to(torch.int32), best, zero, surf if surface else None
    _on_card("ttl_decision", hist)
    stride = _check(hist, time_w, last, edges, s_price, n_price, first_remote)
    e_dim, c_dim = hist.shape
    dev = hist.device
    idx = torch.empty(e_dim, dtype=torch.int32, device=dev)
    best = torch.empty(e_dim, dtype=torch.float32, device=dev)
    zero = torch.empty(e_dim, dtype=torch.float32, device=dev)
    surf = (torch.empty((e_dim, c_dim), dtype=torch.float32, device=dev)
            if surface else None)
    if e_dim:
        _launch(dev, hist.data_ptr(), time_w.data_ptr(), last.data_ptr(),
                stride, edges.data_ptr(), s_price.data_ptr(),
                n_price.data_ptr(), first_remote.data_ptr(),
                None if surf is None else surf.data_ptr(), idx.data_ptr(),
                best.data_ptr(), zero.data_ptr(), e_dim, c_dim)
    return idx, best, zero, surf
