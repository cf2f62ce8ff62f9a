"""Build and load the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, bound with ``ctypes``.

Each kernel source is compiled at first use into ``build/`` at the repository
root, named by a hash of the source and of every ``csrc/*.cuh`` header, so
an edited source or header is never served by a stale build.  Nothing is
compiled or loaded at import: the CPU tests import the kernel modules on
hosts without a card.  :meth:`CudaLibrary.start` begins a build without
waiting for it, so several sources compile at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc(source: Path) -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found: the kernel is built from {source} at first use and "
        "needs the CUDA toolkit")


class CudaLibrary:
    """One kernel source and its compiled library, loaded once per process.

    ``bind`` declares the ``argtypes`` / ``restype`` of the library's C
    entry points.
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self.lib: Optional[ctypes.CDLL] = None
        self.seconds: Optional[float] = None   # nvcc wall time (None = reused)
        self.log = ""                          # nvcc / ptxas output of that build
        self._proc = None
        self._t0 = 0.0

    def _target(self) -> Path:
        digest = hashlib.sha256()
        for path in (self.source, *sorted(CSRC.glob("*.cuh"))):
            digest.update(path.read_bytes())
        tag = digest.hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{tag}.so"

    def _tmp(self, so: Path) -> Path:
        return so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")

    def start(self) -> None:
        """Start ``nvcc`` in the background unless the library is built,
        loaded, or already being built by this process."""
        so = self._target()
        if self.lib is not None or self._proc is not None or so.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [_nvcc(self.source), *NVCC_FLAGS, "-o", str(self._tmp(so)),
             str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load(self) -> ctypes.CDLL:
        """Build (if needed), wait for the build, and load the library."""
        if self.lib is not None:
            return self.lib
        self.start()
        so = self._target()
        if self._proc is not None:
            out, _ = self._proc.communicate()
            code, self._proc = self._proc.returncode, None
            if code != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n{out}")
            os.replace(self._tmp(so), so)   # atomic: concurrent builds race safely
            self.seconds = time.perf_counter() - self._t0
            self.log = out
        lib = ctypes.CDLL(str(so))
        self._bind(lib)
        self.lib = lib
        return lib
