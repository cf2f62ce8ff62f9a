"""The 800-cell variable-granularity inter-access-time histogram (paper §3.2.3),
on float64 CPU tensors.

Two resolutions:
  * cells 0..59: one cell per second for the first minute;
  * cells 60..: logarithmic with base 1.02 starting at one minute, so that two
    consecutive candidate TTLs differ by <= 2% (and hence the storage-cost term,
    which is linear in TTL, by <= 2% as well).  740 log cells cover
    (1.02)**740 minutes -- years of range with an 800-cell table.

Two weighted histograms are collected per (bucket, target region):
  * ``hist(j)``  -- bytes of GETs whose inter-access gap T_next fell in range(j);
  * ``last(j)``  -- bytes *not* re-read, bucketed by how long they have been
    observed without a re-read (time from their final access to "now").

We additionally track the weighted sum of gap times per cell so that the exact
weighted mean t-hat(j) of Table 1 is available.

Ingestion stays on the CPU on purpose: a CUDA ``index_add_`` accumulates with
atomics in no fixed order, while the CPU ``index_add_`` adds duplicates
sequentially in index order -- bit for bit what ``np.add.at`` does -- so the
histograms, and every TTL decided from them, are reproducible.  The batched
(edges x cells) form is consumed by :mod:`repro_torch.kernels.ttl_scan`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

#: Default construction parameters (paper §3.2.3).
N_LINEAR = 60            # one-second cells
N_LOG = 740              # log cells, base 1.02, starting at 60 s
LOG_BASE = 1.02

F64 = torch.float64
CPU = torch.device("cpu")


def _f64(x) -> torch.Tensor:
    """``x`` as a 1-D float64 CPU tensor (numpy arrays, lists and scalars
    convert; tensors are cast, never aliased to a different dtype)."""
    return torch.atleast_1d(torch.as_tensor(x, dtype=F64, device=CPU))


def cell_edges(
    n_linear: int = N_LINEAR, n_log: int = N_LOG, base: float = LOG_BASE
) -> torch.Tensor:
    """Upper boundaries t(j) of every cell, in seconds.  Shape (n_linear+n_log,).

    Cell j covers (edges[j-1], edges[j]] with edges[-1] == 0.

    The powers are taken with numpy: its ``pow`` is the C library's, while
    torch's vectorized ``pow`` may round the last bit differently, and a
    boundary one ulp off moves a gap that lands exactly on it.
    """
    lin = np.arange(1, n_linear + 1, dtype=np.float64)           # 1..60 s
    log = 60.0 * base ** np.arange(1, n_log + 1, dtype=np.float64)
    return torch.from_numpy(np.concatenate([lin, log]))


def cell_mid(edges: torch.Tensor) -> torch.Tensor:
    """Cell midpoints ``0.5 * (lower + upper)`` with lower(0) == 0."""
    lower = torch.cat([edges.new_zeros(1), edges[:-1]])
    return 0.5 * (lower + edges)


@dataclasses.dataclass
class AccessHistogram:
    """One (bucket, region) pair's workload statistics (Table 1)."""

    edges: torch.Tensor               # upper cell boundaries t(j), seconds
    hist: torch.Tensor                # bytes re-read with gap in range(j)
    time_weight: torch.Tensor         # sum of gap * bytes, for exact t-hat(j)
    last: torch.Tensor                # bytes not re-read, by observation age
    first_read_remote_bytes: float    # bytes whose *initial* GET was remote
    n_samples: int

    @classmethod
    def empty(cls, edges=None) -> "AccessHistogram":
        e = cell_edges() if edges is None else _f64(edges)
        z = torch.zeros(e.shape[0], dtype=F64)
        return cls(e, z.clone(), z.clone(), z.clone(), 0.0, 0)

    @classmethod
    def from_numpy(cls, edges, hist, time_weight, last,
                   first_read_remote_bytes: float,
                   n_samples: int) -> "AccessHistogram":
        """Load a collection window held as numpy arrays (copied, float64)."""
        return cls(*(torch.tensor(np.asarray(a, dtype=np.float64))
                     for a in (edges, hist, time_weight, last)),
                   float(first_read_remote_bytes), int(n_samples))

    # -- updates --------------------------------------------------------------
    def cell_of(self, dt_seconds) -> torch.Tensor:
        """Cell index for each gap; gaps beyond the last edge clamp to the top."""
        idx = torch.searchsorted(self.edges, _f64(dt_seconds), side="left")
        return idx.clamp_max_(self.edges.shape[0] - 1)

    def add_gaps(self, dt_seconds, size_bytes) -> None:
        """Record re-reads: object of size ``size_bytes`` re-read ``dt`` after
        its previous access in this region."""
        dt = _f64(dt_seconds)
        sz = _f64(size_bytes).expand(dt.shape)
        cells = self.cell_of(dt)
        self.hist.index_add_(0, cells, sz)
        self.time_weight.index_add_(0, cells, sz * dt)
        self.n_samples += dt.shape[0]

    def add_last(self, age_seconds, size_bytes) -> None:
        """Record not-yet-re-read bytes by their observation age."""
        age = _f64(age_seconds)
        sz = _f64(size_bytes).expand(age.shape)
        self.last.index_add_(0, self.cell_of(age), sz)

    def add_first_read(self, size_bytes: float, remote: bool) -> None:
        if remote:
            self.first_read_remote_bytes += float(size_bytes)

    # -- views ------------------------------------------------------------------
    def t_hat(self) -> torch.Tensor:
        """Exact weighted mean gap per cell; midpoint fallback for empty cells."""
        return torch.where(self.hist > 0,
                           self.time_weight / self.hist.clamp_min(1e-30),
                           cell_mid(self.edges))

    def _check_layout(self, other: "AccessHistogram") -> None:
        if other.edges is self.edges:
            return
        if (other.edges.shape != self.edges.shape
                or not torch.allclose(other.edges, self.edges)):
            raise ValueError("histograms with different cell layouts")

    def merge(self, other: "AccessHistogram") -> "AccessHistogram":
        self._check_layout(other)
        return AccessHistogram(
            self.edges,
            self.hist + other.hist,
            self.time_weight + other.time_weight,
            self.last + other.last,
            self.first_read_remote_bytes + other.first_read_remote_bytes,
            self.n_samples + other.n_samples,
        )

    def copy(self) -> "AccessHistogram":
        return AccessHistogram(self.edges, self.hist.clone(),
                               self.time_weight.clone(), self.last.clone(),
                               self.first_read_remote_bytes, self.n_samples)

    def decay(self, factor: float) -> None:
        """Exponential aging used by the periodic re-collection (§3.2.3): the
        previous histogram is kept but down-weighted as the new one fills up."""
        self.hist *= factor
        self.time_weight *= factor
        self.last *= factor
        self.first_read_remote_bytes *= factor

    def as_arrays(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
        return self.edges, self.hist, self.t_hat(), self.last

    @property
    def total_reread_bytes(self) -> float:
        return float(self.hist.sum())

    @property
    def total_last_bytes(self) -> float:
        return float(self.last.sum())


def from_numpy(edges, hist, time_weight, last, first_read_remote_bytes: float,
               n_samples: int) -> AccessHistogram:
    """An :class:`AccessHistogram` loaded from numpy arrays -- how a window
    collected elsewhere (e.g. by the JAX reference) is carried across."""
    return AccessHistogram.from_numpy(edges, hist, time_weight, last,
                                      first_read_remote_bytes, n_samples)


class RollingHistogram:
    """Periodic re-collection wrapper (§3.2.3).

    Keeps a *current* and a *previous* window; TTL estimation always sees the
    merged view, so a freshly rotated (near-empty) current window never starves
    the policy.  ``rotate()`` is called once the current window is longer than
    T_even (the paper's guidance: "the histogram should be longer than the
    T_even time to be effective").
    """

    def __init__(self, edges=None):
        self.current = AccessHistogram.empty(edges)
        self.previous: AccessHistogram | None = None
        self.window_start = 0.0
        # Pending (gap, size) samples queued by queue_gap: the ingestion hot
        # path appends two floats; flush() applies them in one add_gaps call.
        # index_add_ on the CPU accumulates sequentially in index order, so
        # the flushed result is bit-identical to per-sample adds.
        self._pending_dt: list = []
        self._pending_sz: list = []

    @classmethod
    def from_numpy(cls, edges, hist, time_weight, last,
                   first_read_remote_bytes: float, n_samples: int,
                   window_start: float = 0.0) -> "RollingHistogram":
        """A rolling window whose current window is loaded from numpy arrays
        (no previous window)."""
        roll = cls(edges)
        roll.current = AccessHistogram.from_numpy(
            edges, hist, time_weight, last, first_read_remote_bytes, n_samples)
        roll.window_start = float(window_start)
        return roll

    def queue_gap(self, dt: float, size: float) -> None:
        """Buffer one re-read gap sample; applied on the next :meth:`flush`
        (which :meth:`merged` and :meth:`rotate` run implicitly)."""
        self._pending_dt.append(dt)
        self._pending_sz.append(size)

    def queue_gaps(self, dts, sizes) -> None:
        """Buffer a whole chunk of gap samples at once, for offline producers
        that know no estimation read can interleave (a refresh mid-chunk
        would otherwise read a histogram missing the chunk's earlier
        samples).  Bit-identical to the same sequence of :meth:`queue_gap`."""
        self._pending_dt.extend(float(x) for x in dts)
        self._pending_sz.extend(float(x) for x in sizes)

    def flush(self) -> None:
        """Apply queued gap samples to the current window, vectorized."""
        if self._pending_dt:
            self.current.add_gaps(self._pending_dt, self._pending_sz)
            self._pending_dt.clear()
            self._pending_sz.clear()

    def rotate(self, now: float) -> None:
        self.flush()
        self.previous = self.current
        self.current = AccessHistogram.empty(self.current.edges)
        self.window_start = now

    def merged(self) -> AccessHistogram:
        """A point-in-time snapshot of the estimation view.  Both branches
        return a *defensive* copy: callers may decay() or otherwise mutate
        the returned histogram without corrupting the live window."""
        self.flush()
        if self.previous is None:
            return self.current.copy()
        m = self.current.merge(self.previous)
        # ``last`` is a point-in-time census (set by the snapshot scan), not an
        # accumulating stream: only the current window's census is valid --
        # merging both would double-count every paused object.
        m.last = self.current.last.clone()
        return m
