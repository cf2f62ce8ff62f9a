"""Batched ExpectedCost(TTL) scan (paper §3.2.2): the CUDA kernel for Hopper,
its build, its ctypes binding and its launch counter.

The metadata server periodically recomputes, for every (bucket x directed
edge) pair, the expected cost of all ~800 candidate TTLs and takes the argmin
(§6.7.3: regions x buckets x incoming edges = ~100k edge problems per
refresh).  The kernel (``csrc/ttl_scan.cu``) replaces the Pallas TPU kernel
``_ttl_scan_kernel`` of ``src/repro/kernels/ttl_scan.py``; its source note
gives the design and the bound (16 bytes per cell: memory-bound).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/`` at the repository root, named by a hash of the source so an
edited source is never served by a stale build.  Nothing is compiled or
loaded at import: the CPU tests import this module on hosts without a card.

:func:`ttl_cost_surface` dispatches on where its tensors lie: on the CPU it
computes the plain PyTorch version (:func:`repro_torch.kernels.ref.ttl_cost_ref`);
on a CUDA device it launches the kernel or raises.  It never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ttl_scan.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class _Build:
    """The compiled library, loaded once per process."""

    lib = None
    seconds = None      # nvcc wall time of this process's build (None = reused)
    log = ""            # nvcc / ptxas output of that build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found: the TTL-scan kernel is built from {SOURCE} at "
        "first use and needs the CUDA toolkit")


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    if _Build.lib is not None:
        return _Build.lib
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"ttl_scan-{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, so)          # atomic: concurrent builds race safely
        _Build.seconds = time.perf_counter() - t0
        _Build.log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.ttl_scan.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_void_p]
    lib.ttl_scan.restype = ctypes.c_int
    _Build.lib = lib
    return lib


def _check(hist, time_w, last, edges, s_price, n_price, first_remote) -> None:
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
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c_dim < 1 or e_dim * c_dim >= 2**31:
        raise ValueError(f"unsupported problem size E={e_dim}, C={c_dim}")


def ttl_cost_surface(
    hist: torch.Tensor,          # [E, C] float32
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
    if hist.device.type != "cuda":
        raise ValueError(f"ttl_cost_surface runs on cpu or cuda, not "
                         f"{hist.device}")
    _check(hist, time_w, last, edges, s_price, n_price, first_remote)
    lib = library()
    e_dim, c_dim = hist.shape
    out = torch.empty_like(hist)
    if e_dim == 0:
        return out
    with torch.cuda.device(hist.device):
        stream = torch.cuda.current_stream(hist.device).cuda_stream
        err = lib.ttl_scan(
            hist.data_ptr(), time_w.data_ptr(), last.data_ptr(),
            edges.data_ptr(), s_price.data_ptr(), n_price.data_ptr(),
            first_remote.data_ptr(), out.data_ptr(), e_dim, c_dim, stream)
    if err != 0:
        raise RuntimeError(f"ttl_scan launch failed with cudaError {err}")
    ttl_cost_surface.launches += 1
    return out


ttl_cost_surface.launches = 0
