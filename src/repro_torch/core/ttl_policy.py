"""Adaptive TTL selection (paper §3.2.2-§3.3): ExpectedCost(TTL) and its argmin.

Given one (bucket, target-region) histogram pair (``hist``, ``last``) and an
edge's prices (S = storage $/GB/month at the target, N = egress $/GB on the
edge), the expected cost of running a TTL-with-reset eviction policy is the
four-term functional of §3.2.2:

    ExpectedCost(TTL) =   first_read_remote_bytes * N                 (initial GETs)
                        + sum_{j: t(j) <= TTL} hist(j) * t_hat(j) * S (hits)
                        + sum_{j: t(j) >  TTL} hist(j) * (N + TTL*S)  (misses)
                        + sum_{j: t(j) >  TTL} last(j) * TTL * S      (tail storage)
                        [+ sum_{j: t(j) <= TTL} last(j) * age(j) * S  (censored)]

    ``last(j)`` is a census of bytes currently paused (no re-read yet), bucketed
    by pause age.  Bytes paused beyond TTL have, under this TTL, already been
    evicted after paying TTL*S.  Bytes paused *less* than TTL are censored:
    they are certainly being stored right now, so we charge them their
    observed age (the bracketed correction, on by default).

Every decision here is taken in float64 on the CPU: ``torch.cumsum``,
``torch.argmin`` and the elementwise terms reproduce the numpy reference bit
for bit, so the ``python`` and ``torch`` engines decide exactly as it does.
The same computation, batched over every (bucket x directed-edge) pair of
the deployment, is the hot spot that :mod:`repro_torch.kernels.ttl_scan`
implements as a CUDA kernel; the ``torch`` path here is its exact oracle.

The latency extension of §3.3.2 (``U_perf-val`` $/byte willingness to pay per
extra cache hit) is :func:`choose_ttl_with_perf_value`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.ops import _ttl_decide, resolve_device
from .costmodel import GB, SECONDS_PER_MONTH, CostModel
from .histogram import AccessHistogram, RollingHistogram, cell_edges, cell_mid

F64 = torch.float64


def _per_byte_prices(storage_gb_month: float, egress_gb: float) -> Tuple[float, float]:
    """Convert catalog prices to ($ per byte-second, $ per byte)."""
    s = storage_gb_month / GB / SECONDS_PER_MONTH
    n = egress_gb / GB
    return s, n


def _zcat(x: torch.Tensor) -> torch.Tensor:
    """Prepend a zero along the last axis (the TTL=0 candidate's prefix)."""
    return torch.cat([x.new_zeros(x.shape[:-1] + (1,)), x], dim=-1)


def expected_cost_curve(
    h: AccessHistogram,
    storage_gb_month: float,
    egress_gb: float,
    include_censored_tail: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ExpectedCost for every candidate TTL.

    Returns ``(candidate_ttls_seconds, cost_dollars)`` where candidates are
    ``[0, t(0), t(1), ..., t(J-1)]`` (TTL=0 prepended -- evict immediately).
    O(cells) total via prefix/suffix sums.
    """
    s, n = _per_byte_prices(storage_gb_month, egress_gb)
    edges, hist, t_hat, last = h.as_arrays()

    hit_cost_csum = _zcat(torch.cumsum(hist * t_hat, dim=0)) * s
    hist_csum = _zcat(torch.cumsum(hist, dim=0))
    last_csum = _zcat(torch.cumsum(last, dim=0))
    total_hist, total_last = hist_csum[-1], last_csum[-1]

    ttls = _zcat(edges)                                    # candidate k keeps cells < k
    miss_bytes = total_hist - hist_csum                    # bytes with t(j) > TTL_k
    tail_bytes = total_last - last_csum                    # paused longer than TTL_k

    cost = (
        h.first_read_remote_bytes * n
        + hit_cost_csum
        + miss_bytes * (n + ttls * s)
        + tail_bytes * ttls * s
    )
    if include_censored_tail:
        # Censored pauses (age <= TTL) are being stored right now: charge the
        # observed age (cell midpoint -- cells are <=2% wide by construction).
        age_cost_csum = _zcat(torch.cumsum(last * cell_mid(edges), dim=0)) * s
        cost = cost + age_cost_csum
    return ttls, cost


def choose_ttl(
    h: AccessHistogram,
    storage_gb_month: float,
    egress_gb: float,
    **kw,
) -> float:
    """argmin_TTL ExpectedCost(TTL), in seconds (first index on ties)."""
    ttls, cost = expected_cost_curve(h, storage_gb_month, egress_gb, **kw)
    return float(ttls[int(torch.argmin(cost))])


def batched_cost_curves(
    hist,          # [E, C] re-read bytes per cell
    time_w,        # [E, C] sum of gap*bytes per cell
    last,          # [E, C] paused-bytes census per cell
    edges,         # [C]    shared cell layout
    first_remote,  # [E]    initial-GET remote bytes
    s,             # [E]    $ / byte-second at each target
    n,             # [E]    $ / byte on each edge
    include_censored_tail: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized float64 ExpectedCost surfaces for E edge problems sharing
    one cell layout: the batched form of :func:`expected_cost_curve`.

    Returns ``(candidate_ttls [C+1], cost [E, C+1])`` as float64 CPU tensors.
    Row ``i`` is bit-identical to ``expected_cost_curve`` on the same
    inputs: ``torch.cumsum(..., dim=1)`` accumulates each row in the same
    sequential order as the 1-D scan, and every other term is elementwise.
    This is the float64 oracle of the CUDA kernel.
    """
    def f64(x):
        return torch.as_tensor(x, dtype=F64, device="cpu")

    hist, time_w, last, edges, first_remote = (
        f64(x) for x in (hist, time_w, last, edges, first_remote))
    s = f64(s)[:, None]
    n = f64(n)[:, None]

    mid = cell_mid(edges)
    t_hat = torch.where(hist > 0, time_w / hist.clamp_min(1e-30), mid)

    hit_cost_csum = _zcat(torch.cumsum(hist * t_hat, dim=1)) * s
    hist_csum = _zcat(torch.cumsum(hist, dim=1))
    last_csum = _zcat(torch.cumsum(last, dim=1))

    ttls = _zcat(edges)
    miss_bytes = hist_csum[:, -1:] - hist_csum
    tail_bytes = last_csum[:, -1:] - last_csum

    cost = (
        first_remote[:, None] * n
        + hit_cost_csum
        + miss_bytes * (n + ttls[None, :] * s)
        + tail_bytes * ttls[None, :] * s
    )
    if include_censored_tail:
        age_cost_csum = _zcat(torch.cumsum(last * mid, dim=1)) * s
        cost = cost + age_cost_csum
    return ttls, cost


def choose_ttl_with_perf_value(
    h: AccessHistogram,
    storage_gb_month: float,
    egress_gb: float,
    u_perf_val_per_gb: float,
    **kw,
) -> float:
    """§3.3.2: lift the TTL above the cost argmin while the *average* extra cost
    per extra locally-hit byte stays below the user performance value.

    Picks the highest TTL with
        (cost(TTL) - cost(TTL*)) / extra_hit_bytes(TTL*, TTL] <= U_perf-val.
    """
    ttls, cost = expected_cost_curve(h, storage_gb_month, egress_gb, **kw)
    k_star = int(torch.argmin(cost))
    if u_perf_val_per_gb <= 0:
        return float(ttls[k_star])
    u = u_perf_val_per_gb / GB
    hist_csum = _zcat(torch.cumsum(h.hist, dim=0))
    extra_hits = hist_csum - hist_csum[k_star]             # bytes turned into hits
    rate = (cost - cost[k_star]) / extra_hits.clamp_min(1e-30)
    k = torch.arange(ttls.shape[0])
    ok = k >= k_star
    ok &= (extra_hits > 0) | (k == k_star)
    ok &= (rate <= u) | (k == k_star)
    return float(ttls[int(torch.nonzero(ok).max())])


@dataclasses.dataclass
class EdgeTTL:
    """Chosen TTL for one directed edge of the region graph (Fig. 2)."""

    ttl_seconds: float
    chosen_at: float
    expected_cost: float = math.nan


#: TTL-selection engines the refresh loop can run on (see
#: :meth:`AdaptiveTTLController._resolve_engine`):
#:
#:   torch    batched float64 :func:`batched_cost_curves` on the CPU --
#:            bit-identical to the per-edge scalar path;
#:   kernel   the CUDA kernel's fused decision (one launch a refresh) via
#:            :func:`repro_torch.kernels.ops._ttl_decide` on the
#:            controller's device;
#:   torch32  the plain float32 version of the same batched path, on the CPU;
#:   python   the per-edge scalar loop (the reference the equivalence tests
#:            pin the batched engines against);
#:   auto     kernel when the controller's device is CUDA, torch when it is
#:            the CPU.
TTL_ENGINES = ("auto", "kernel", "torch32", "torch", "python")


class AdaptiveTTLController:
    """Per-(bucket, target region) statistics -> per-edge TTLs (§3.3.1).

    The histogram is collected at the *target* region per bucket (bucket-level
    granularity -- §3.2.3: object-level statistics are misleading under bursts);
    each incoming edge gets its own TTL because only N differs per edge.  The
    object-level TTL is then ``min`` over edges whose source currently holds a
    replica, with the eviction-safety filter applied by the placement layer.

    The refresh loop is *batched* (§6.7.3): all incoming edges of one
    (bucket, dst) pair are solved in a single call to the selected
    ``engine``.  TTLs are always resolved by argmin *index* against the
    float64 candidate grid, so engine choice never leaks float32 TTL values
    into the planes.

    ``device`` is where the kernel engine runs ("cuda" by default).  A CUDA
    device that is absent or older than Hopper raises here, at construction;
    pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        cost: CostModel,
        refresh_period: float = 24 * 3600.0,
        warmup_min_samples: int = 32,
        u_perf_val_per_gb: float = 0.0,
        edges=None,
        rotate_multiple_of_t_even: float = 2.0,
        engine: str = "auto",
        device="cuda",
    ) -> None:
        self.cost = cost
        self.refresh_period = refresh_period
        self.warmup_min_samples = warmup_min_samples
        self.u_perf_val_per_gb = u_perf_val_per_gb
        self._cell_edges = cell_edges() if edges is None else edges
        self.hists: Dict[Tuple[str, str], RollingHistogram] = {}
        self.edge_ttls: Dict[Tuple[str, str, str], EdgeTTL] = {}
        self.last_refresh: Dict[Tuple[str, str], float] = {}
        # (bucket, dst) -> (last_refresh stamp, {src: ttl}): edge TTLs only
        # move inside _maybe_refresh, so a whole destination's incoming-edge
        # table can be served from cache between refresh windows (see
        # edge_ttl_table).
        self._ttl_tables: Dict[Tuple[str, str], Tuple[float, Dict[str, float]]] = {}
        self.rotate_multiple = rotate_multiple_of_t_even
        if engine not in TTL_ENGINES:
            raise ValueError(f"unknown TTL engine {engine!r}; have {TTL_ENGINES}")
        self.engine = engine
        self.device = resolve_device(device)
        #: Batched refreshes solved so far (one engine call each).
        self.n_refreshes = 0

    # -- statistics ingestion ------------------------------------------------
    def hist_for(self, bucket: str, region: str) -> RollingHistogram:
        key = (bucket, region)
        if key not in self.hists:
            self.hists[key] = RollingHistogram(self._cell_edges)
        return self.hists[key]

    def record_gap(self, bucket: str, region: str, dt: float, size: float) -> None:
        # Queued, not applied: RollingHistogram flushes the queue in one
        # vectorized (bit-identical) add_gaps before any estimation read.
        self.hist_for(bucket, region).queue_gap(float(dt), float(size))

    def record_gaps(self, bucket: str, region: str, dts, sizes) -> None:
        """Chunk-bulk form of :meth:`record_gap` for offline producers (see
        :meth:`RollingHistogram.queue_gaps` for why replay does not use it)."""
        self.hist_for(bucket, region).queue_gaps(dts, sizes)

    def record_first_read(self, bucket: str, region: str, size: float, remote: bool) -> None:
        self.hist_for(bucket, region).current.add_first_read(size, remote)

    def set_last_snapshot(self, bucket: str, region: str, ages, sizes) -> None:
        h = self.hist_for(bucket, region).current
        h.last.zero_()
        if len(ages):
            h.add_last(ages, sizes)

    # -- TTL queries ----------------------------------------------------------
    def edge_ttl(self, bucket: str, src: str, dst: str, now: float) -> float:
        """TTL for the (src -> dst) edge; T_even warmup before enough samples."""
        self._maybe_refresh(bucket, dst, now)
        e = self.edge_ttls.get((bucket, src, dst))
        if e is None:
            return self.cost.t_even_seconds(src, dst)
        return e.ttl_seconds

    def edge_ttl_table(self, bucket: str, dst: str, now: float) -> Dict[str, float]:
        """Every incoming edge's TTL for ``(bucket, dst)`` at ``now`` as one
        dict ``{src: ttl}`` -- each value exactly what ``edge_ttl(bucket,
        src, dst, now)`` would return, amortized across the per-GET callers.

        Edge TTLs only change inside :meth:`_maybe_refresh`, which is gated
        on ``refresh_period``; between refreshes the table is constant, so it
        is cached against the ``last_refresh`` stamp and the same period
        gate.  The first read past the period boundary triggers the refresh
        either way."""
        key = (bucket, dst)
        cached = self._ttl_tables.get(key)
        if cached is not None:
            last, tbl = cached
            if now - last < self.refresh_period and self.last_refresh.get(key) == last:
                return tbl
        self._maybe_refresh(bucket, dst, now)
        edge_ttls, t_even = self.edge_ttls, self.cost.t_even_seconds
        tbl = {}
        for src in self.cost.regions:
            if src == dst:
                continue
            e = edge_ttls.get((bucket, src, dst))
            tbl[src] = t_even(src, dst) if e is None else e.ttl_seconds
        self._ttl_tables[key] = (self.last_refresh[key], tbl)
        return tbl

    def object_ttl(
        self, bucket: str, dst: str, holder_regions, now: float
    ) -> float:
        """min over edges from replica-holding regions (§3.3.1)."""
        ttls = [
            self.edge_ttl(bucket, src, dst, now)
            for src in holder_regions
            if src != dst
        ]
        if not ttls:
            return math.inf
        return float(min(ttls))

    # -- refresh loop ----------------------------------------------------------
    def _resolve_engine(self) -> str:
        """``auto`` is the kernel on a CUDA device and the batched float64
        path on the CPU."""
        if self.engine != "auto":
            return self.engine
        return "kernel" if self.device.type == "cuda" else "torch"

    def _maybe_refresh(self, bucket: str, dst: str, now: float) -> None:
        key = (bucket, dst)
        last = self.last_refresh.get(key, -math.inf)
        if now - last < self.refresh_period:
            return
        self.last_refresh[key] = now
        roll = self.hist_for(bucket, dst)
        merged = roll.merged()
        if merged.n_samples < self.warmup_min_samples:
            return
        s = self.cost.storage_price(dst)
        srcs = [src for src in self.cost.region_names() if src != dst]
        engine = self._resolve_engine()
        if self.u_perf_val_per_gb > 0 or engine == "python":
            # Scalar reference path: the §3.3.2 perf-value lift walks the
            # per-edge curve beyond the argmin, so it stays on the scalar
            # implementation; engine="python" keeps the per-edge loop
            # selectable as the equivalence oracle.
            for src in srcs:
                n = self.cost.egress_price(src, dst)
                if self.u_perf_val_per_gb > 0:
                    ttl = choose_ttl_with_perf_value(
                        merged, s, n, self.u_perf_val_per_gb)
                else:
                    ttl = choose_ttl(merged, s, n)
                _ttls_c, cost_c = expected_cost_curve(merged, s, n)
                self.edge_ttls[(bucket, src, dst)] = EdgeTTL(
                    ttl, now, float(cost_c.min())
                )
        else:
            ttls, costs = self._refresh_batched(merged, dst, srcs, engine)
            self.n_refreshes += 1
            for src, ttl, c in zip(srcs, ttls.tolist(), costs.tolist()):
                self.edge_ttls[(bucket, src, dst)] = EdgeTTL(ttl, now, c)
        # Rotate the collection window once it is comfortably longer than the
        # largest T_even of any incoming edge (§3.2.3 guidance).
        t_even_max = max(
            self.cost.t_even_seconds(src, dst)
            for src in self.cost.region_names()
            if src != dst
        )
        if now - roll.window_start > self.rotate_multiple * t_even_max:
            roll.rotate(now)

    def _refresh_batched(
        self, merged: AccessHistogram, dst: str, srcs: list, engine: str,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Solve every incoming edge of (bucket, dst) in one batched call.

        All rows share the merged target-side histogram; only the per-edge
        egress price N varies.  Returns ``(ttl_seconds [E], best_cost [E])``
        with TTLs off the float64 candidate grid on every engine.
        """
        if engine == "torch":
            e_dim = len(srcs)
            s_gbmo = self.cost.storage_price(dst)
            s = torch.full((e_dim,), s_gbmo / GB / SECONDS_PER_MONTH, dtype=F64)
            n = torch.tensor([self.cost.egress_price(src, dst) / GB
                              for src in srcs], dtype=F64)
            shape = (e_dim, merged.hist.shape[0])
            ttls, cost = batched_cost_curves(
                merged.hist.expand(shape), merged.time_weight.expand(shape),
                merged.last.expand(shape), merged.edges,
                torch.full((e_dim,), merged.first_read_remote_bytes,
                           dtype=F64), s, n)
            idx = torch.argmin(cost, dim=1)
            return ttls[idx], cost[torch.arange(e_dim), idx]
        # kernel / torch32: the float32 decision with float64 candidate
        # resolution (canonical argmin ties), one histogram shared by every
        # row and no surface: on the card, one copy in, one launch, one copy
        # out.
        s = torch.full((len(srcs),),
                       self.cost.storage_price(dst) / GB / SECONDS_PER_MONTH,
                       dtype=F64)
        n = torch.tensor([self.cost.egress_price(src, dst) / GB
                          for src in srcs], dtype=F64)
        device = self.device if engine == "kernel" else torch.device("cpu")
        ttls, costs, _ = _ttl_decide(merged, s, n, device)
        return ttls, costs
