"""Placement/eviction policies: SkyStore and every baseline of §6.2.2.

The simulator owns the *mechanics* shared by all policies (write-local storage,
cheapest-source reads, replica bookkeeping, FB/FP safety rules, storage/egress
accounting); a :class:`Policy` supplies the *decisions*:

  * ``replicate_on_write(obj, region)`` -- extra targets to push a fresh PUT to
    (empty for everything except SPANStore / AWS-MRB / JuiceFS);
  * ``cache_on_read(...)``              -- replicate-on-read?
  * ``ttl_on_access(...)``              -- replica TTL (seconds; inf = pin);
  * ``observe_get(...)``                -- statistics callback.

Policies never mutate simulator state; the simulator applies FB ("base replica
is never evicted") and FP ("never evict the sole copy") invariants on top of
whatever TTLs a policy returns.

This is the PyTorch port's copy of :mod:`repro.core.policies`.  Only SkyStore
touches tensors (through its :class:`AdaptiveTTLController`); ``device`` is
where that controller's TTL kernel runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.ops import resolve_device
from .costmodel import GB, CostModel
from .ttl_policy import AdaptiveTTLController

INF = float("inf")


@dataclasses.dataclass
class GetContext:
    obj: int
    bucket: str
    region: str            # where the GET lands
    src_region: str        # replica it will be / was served from
    size: float
    now: float
    hit: bool
    gap: Optional[float]   # time since previous GET of obj at region (None = first)


class Oracle:
    """Future knowledge handed to clairvoyant policies (CGP, SPANStore solver).

    ``next_access[(obj, region)]`` is the sorted array of GET times of ``obj``
    at ``region``; :meth:`next_get_after` binary-searches it.

    The concrete trace-backed implementation both verification planes share
    is :class:`repro_torch.core.oracle.TraceOracle` (built once from the
    :class:`~repro_torch.core.traces.Trace` before replay); policies with
    ``requires_oracle = True`` refuse to run on the live plane until one is
    attached (``VirtualStore(policy=..., oracle=...)``).
    """

    def __init__(self, next_access: Dict[Tuple[int, str], np.ndarray]):
        self._na = next_access

    def next_get_after(self, obj: int, region: str, now: float) -> float:
        times = self._na.get((obj, region))
        if times is None:
            return INF
        i = np.searchsorted(times, now, side="right")
        return float(times[i]) if i < len(times) else INF

    def gets_in_window(
        self, region: str, t0: float, t1: float
    ) -> Dict[int, Tuple[int, float]]:
        raise NotImplementedError  # implemented by TraceOracle


class Policy:
    name = "base"
    requires_oracle = False
    #: Epoch-solver interval in seconds (None = no epochs).  A policy that
    #: sets this must implement ``solve_epoch(get_bytes, put_bytes)`` and
    #: expose ``replica_sets``; the event spine then emits EPOCH boundaries
    #: every ``epoch`` seconds and both planes re-run the solver there,
    #: feeding it the upcoming epoch's workload from an attached oracle
    #: (``TraceOracle.from_trace(trace, epoch_len=policy.epoch)`` -- the
    #: simulator builds one automatically, the live VirtualStore refuses to
    #: construct without one).  SPANStore is the one such policy today.
    epoch: Optional[float] = None
    #: §6.3 latency-vs-egress GET-routing knob: both planes score candidate
    #: sources by ``egress_price + latency_weight * get_latency_ms`` (so the
    #: weight converts milliseconds into dollars).  Zero -- the default for
    #: every cost-only policy -- keeps the original price-only decision
    #: stream bit-identical (routing takes the unweighted branch verbatim).
    latency_weight: float = 0.0

    def __init__(self, cost: CostModel):
        self.cost = cost
        self.oracle: Optional[Oracle] = None

    def reset(self) -> None:
        pass

    # -- decisions -------------------------------------------------------------
    def replicate_on_write(self, obj: int, bucket: str, region: str, size: float,
                           now: float) -> List[str]:
        return []

    def cache_on_read(self, ctx: GetContext) -> bool:
        return True

    def ttl_on_access(self, ctx: GetContext, holder_regions: Sequence[str]) -> float:
        return INF

    # -- statistics --------------------------------------------------------------
    def observe_get(self, ctx: GetContext) -> None:
        pass

    def periodic(self, now: float, sim) -> None:
        """Hook called at every simulator maintenance tick (eviction scan)."""

    def region_available(self, region: str, available: bool, now: float) -> None:
        """§6.4 failure-plane hook: called by both planes when ``region``
        goes down (``available=False``) or recovers (``True``) -- *after*
        the plane updated its own unavailability state and, on recovery,
        after deferred base syncs replayed, so a policy observing holders
        sees the post-recovery placement.  Policies that pre-position
        replicas (or want to re-replicate after an outage) react here; the
        built-in policies are availability-agnostic -- the mechanics layer
        already fails GETs over and redirects PUTs for them."""


# ---------------------------------------------------------------------------
# Trivial baselines
# ---------------------------------------------------------------------------

class AlwaysEvict(Policy):
    """Store each object in a single location; never replicate on read."""

    name = "always_evict"

    def cache_on_read(self, ctx: GetContext) -> bool:
        return False

    def ttl_on_access(self, ctx, holders) -> float:
        return 0.0


class AlwaysStore(Policy):
    """Replicate to every GET region; never evict."""

    name = "always_store"

    def ttl_on_access(self, ctx, holders) -> float:
        return INF


class TevenPolicy(Policy):
    """Static TTL = N/S for the serving edge (§3.1.2; 2-competitive)."""

    name = "t_even"

    def ttl_on_access(self, ctx, holders) -> float:
        srcs = [h for h in holders if h != ctx.region] or [ctx.src_region]
        return min(self.cost.t_even_seconds(s, ctx.region) for s in srcs)


class ReplicateOnWrite(Policy):
    """AWS Multi-Region Bucket / GCP MR / JuiceFS: push every PUT to the
    configured secondary regions, never evict (§6.2.2 industrial baselines)."""

    def __init__(self, cost: CostModel, targets: Optional[Sequence[str]] = None,
                 name: str = "juicefs"):
        super().__init__(cost)
        self._targets = list(targets) if targets is not None else None
        self.name = name

    def replicate_on_write(self, obj, bucket, region, size, now) -> List[str]:
        if self._targets is None:
            return [r for r in self.cost.region_names() if r != region]
        return [r for r in self._targets if r != region]

    def ttl_on_access(self, ctx, holders) -> float:
        return INF


def aws_multi_region(cost: CostModel, **kw) -> ReplicateOnWrite:
    return ReplicateOnWrite(cost, name="aws_mrb", **kw)


def juicefs(cost: CostModel, **kw) -> ReplicateOnWrite:
    return ReplicateOnWrite(cost, name="juicefs", **kw)


# ---------------------------------------------------------------------------
# Learned baselines
# ---------------------------------------------------------------------------

class EWMAPolicy(Policy):
    """Predict each object's next inter-access gap with an exponentially
    weighted moving average (alpha = 0.5, §6.2.2) and keep the replica exactly
    that long -- iff the prediction beats T_even."""

    name = "ewma"

    def __init__(self, cost: CostModel, alpha: float = 0.5):
        super().__init__(cost)
        self.alpha = alpha
        self._ema: Dict[Tuple[int, str], float] = {}

    def reset(self) -> None:
        self._ema.clear()

    def observe_get(self, ctx: GetContext) -> None:
        if ctx.gap is None:
            return
        key = (ctx.obj, ctx.region)
        prev = self._ema.get(key)
        self._ema[key] = (
            ctx.gap if prev is None else self.alpha * ctx.gap + (1 - self.alpha) * prev
        )

    def _t_even(self, ctx: GetContext) -> float:
        return self.cost.t_even_seconds(ctx.src_region, ctx.region)

    def cache_on_read(self, ctx: GetContext) -> bool:
        pred = self._ema.get((ctx.obj, ctx.region))
        if pred is None:
            return True                      # no history: optimistic first cache
        return pred <= self._t_even(ctx)

    def ttl_on_access(self, ctx, holders) -> float:
        pred = self._ema.get((ctx.obj, ctx.region))
        t_even = self._t_even(ctx)
        if pred is None:
            return t_even
        return pred * 1.25 if pred <= t_even else 0.0


class TTLCC(Policy):
    """TTL-CC [Carra et al., INFOCOM'19]: one dynamic TTL per workload,
    adjusted by stochastic approximation of dCost/dTTL from each observed
    inter-access gap (smooth/Poisson-like behaviour assumed -- the assumption
    the paper shows fails on bursty traces).

    Per-sample gradient of the §3.2.2 functional wrt TTL at gap ``dt``:
        +S                if dt > ttl            (longer TTL => more idle storage)
        -N / (ttl * eps)  if ttl < dt <= ttl(1+eps)   (kernel-smoothed miss->hit jump)
    Updates are multiplicative to stay scale-free.
    """

    name = "ttl_cc"
    per_object = False

    def __init__(self, cost: CostModel, lr: float = 0.08, eps: float = 0.25):
        super().__init__(cost)
        self.lr, self.eps = lr, eps
        self._theta: Dict[Tuple, float] = {}

    def reset(self) -> None:
        self._theta.clear()

    def _key(self, ctx: GetContext):
        return (ctx.obj, ctx.region) if self.per_object else (ctx.bucket, ctx.region)

    def _get_theta(self, ctx: GetContext) -> float:
        return self._theta.setdefault(
            self._key(ctx), self.cost.t_even_seconds(ctx.src_region, ctx.region)
        )

    def observe_get(self, ctx: GetContext) -> None:
        if ctx.gap is None:
            return
        theta = self._get_theta(ctx)
        s_per_sec = self.cost.storage_price(ctx.region) / GB / (30 * 24 * 3600.0)
        n = self.cost.egress_price(ctx.src_region, ctx.region) / GB
        g = 0.0
        if ctx.gap > theta:
            g += s_per_sec
        if theta < ctx.gap <= theta * (1.0 + self.eps):
            g -= n / max(theta * self.eps, 1e-9)
        # Scale-free multiplicative step, clipped for stability.
        step = math.tanh(-self.lr * g / max(s_per_sec, 1e-30))
        self._theta[self._key(ctx)] = float(
            min(max(theta * math.exp(step), 1.0), 10 * 365 * 24 * 3600.0)
        )

    def ttl_on_access(self, ctx, holders) -> float:
        return self._get_theta(ctx)


class TTLCCObj(TTLCC):
    """TTL-CC-obj (Table 3): the same controller at per-object granularity."""

    name = "ttl_cc_obj"
    per_object = True


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

class ClairvoyantGreedy(Policy):
    """CGP (§3.1.1): Belady adapted to cost.  On the i-th GET, keep the replica
    iff T_next <= T_even for the serving edge; objects with no next GET are
    evicted immediately.  Cost-optimal in the 2-region base/cache setup."""

    name = "cgp"
    requires_oracle = True

    def _decision(self, ctx: GetContext) -> Tuple[bool, float]:
        t_next = self.oracle.next_get_after(ctx.obj, ctx.region, ctx.now)
        if t_next == INF:
            return False, 0.0
        dt = t_next - ctx.now
        if ctx.src_region != ctx.region:
            t_even = self.cost.t_even_seconds(ctx.src_region, ctx.region)
        else:  # served locally: compare against the cheapest re-fetch edge
            t_even = min(
                self.cost.t_even_seconds(r, ctx.region)
                for r in self.cost.region_names()
                if r != ctx.region
            )
        return dt <= t_even, dt * 1.000001 + 1e-6

    def cache_on_read(self, ctx: GetContext) -> bool:
        keep, _ = self._decision(ctx)
        return keep

    def ttl_on_access(self, ctx, holders) -> float:
        keep, ttl = self._decision(ctx)
        return ttl if keep else 0.0


class SPANStore(Policy):
    """SPANStore [SOSP'13] (§6.2.2): hourly replica-set solver with oracle
    workload knowledge, FP mode only.  Every epoch it chooses, per bucket, the
    replica set minimizing   storage(set) + sum_region GETbytes * min egress +
    PUT replication cost,   then pushes PUTs to that set; no TTL eviction --
    replicas outside the chosen set are dropped at epoch boundaries (keeping
    >= 1 copy).  Replication/eviction costs are *not* part of its objective
    (the paper's criticism), which is why it over-replicates cold buckets.
    """

    name = "spanstore"
    requires_oracle = True
    mode = "FP"

    def __init__(self, cost: CostModel, epoch: float = 3600.0):
        super().__init__(cost)
        self.epoch = epoch
        self.replica_sets: Dict[str, Tuple[str, ...]] = {}
        self._epoch_idx = -1

    def reset(self) -> None:
        self.replica_sets.clear()
        self._epoch_idx = -1

    # Epoch workload summaries are injected by the simulator (which owns the
    # trace): {bucket: {region: get_bytes}}, {bucket: {region: put_bytes}}.
    def solve_epoch(
        self,
        get_bytes: Dict[str, Dict[str, float]],
        put_bytes: Dict[str, Dict[str, float]],
    ) -> None:
        # sorted(): bucket order must not depend on PYTHONHASHSEED -- each
        # bucket solves independently, but decision-path iteration stays
        # deterministic by contract (replaylint RS003).
        for bucket in sorted(set(get_bytes) | set(put_bytes)):
            gb_ = get_bytes.get(bucket, {})
            pb_ = put_bytes.get(bucket, {})
            self.replica_sets[bucket] = self._solve_bucket(gb_, pb_)

    def _solve_bucket(
        self, get_bytes: Dict[str, float], put_bytes: Dict[str, float]
    ) -> Tuple[str, ...]:
        regions = list(self.cost.region_names())
        stored = sum(put_bytes.values()) + 1e-9        # epoch's resident bytes
        month_frac = self.epoch / (30 * 24 * 3600.0)

        def set_cost(rs: Tuple[str, ...]) -> float:
            c = sum(
                self.cost.storage_price(r) * stored / GB * month_frac for r in rs
            )
            for region, gbytes in get_bytes.items():
                c += min(self.cost.egress_price(s, region) for s in rs) * gbytes / GB
            for region, pbytes in put_bytes.items():
                c += sum(
                    self.cost.egress_price(region, r) for r in rs if r != region
                ) * pbytes / GB
            return c

        # Greedy set construction (the full ILP is overkill at bucket counts).
        best: Tuple[str, ...] = (min(
            regions, key=lambda r: set_cost((r,))
        ),)
        improved = True
        while improved:
            improved = False
            for r in regions:
                if r in best:
                    continue
                cand = tuple(sorted(best + (r,)))
                if set_cost(cand) < set_cost(best):
                    best, improved = cand, True
        return best

    def replicate_on_write(self, obj, bucket, region, size, now) -> List[str]:
        rs = self.replica_sets.get(bucket, (region,))
        return [r for r in rs if r != region]

    def cache_on_read(self, ctx: GetContext) -> bool:
        return ctx.region in self.replica_sets.get(ctx.bucket, ())

    def ttl_on_access(self, ctx, holders) -> float:
        return INF   # eviction happens only at epoch boundaries (simulator hook)


# ---------------------------------------------------------------------------
# SkyStore
# ---------------------------------------------------------------------------

class SkyStorePolicy(Policy):
    """The paper's policy: write-local + replicate-on-read + adaptive TTL from
    the (bucket, region) histogram, per-edge TTLs min-combined per object.

    ``size_stratified`` is a beyond-paper refinement:
    histograms are additionally keyed by the object's log4-size class, so a
    48 MB satellite image and a 3 KB manifest sharing a bucket stop polluting
    each other's inter-access statistics (the paper's own §3.2.3 bucket-
    granularity argument, taken one axis further)."""

    name = "skystore"

    def __init__(
        self,
        cost: CostModel,
        refresh_period: float = 24 * 3600.0,
        warmup_min_samples: int = 32,
        u_perf_val_per_gb: float = 0.0,
        size_stratified: bool = False,
        engine: str = "auto",
        device="cuda",
    ):
        super().__init__(cost)
        self.size_stratified = size_stratified
        # ``engine`` selects the controller's TTL refresh implementation
        # (repro_torch.core.ttl_policy.TTL_ENGINES) and ``device`` where its
        # kernel runs; plumbed through so whole-plane replays can pin kernel
        # decisions == scalar-python decisions.
        self._ctl_kwargs = dict(
            refresh_period=refresh_period,
            warmup_min_samples=warmup_min_samples,
            u_perf_val_per_gb=u_perf_val_per_gb,
            engine=engine,
            device=device,
        )
        self.ctl = self._mk()

    def _mk(self) -> AdaptiveTTLController:
        return AdaptiveTTLController(self.cost, **self._ctl_kwargs)

    def reset(self) -> None:
        self.ctl = self._mk()

    def _bkey(self, bucket: str, size: float) -> str:
        if not self.size_stratified:
            return bucket
        cls = int(math.log(max(size, 1.0), 4.0) / 2)    # ~one class per 16x
        return f"{bucket}#s{cls}"

    def observe_get(self, ctx: GetContext) -> None:
        bkey = self._bkey(ctx.bucket, ctx.size)
        if ctx.gap is not None:
            self.ctl.record_gap(bkey, ctx.region, ctx.gap, ctx.size)
        else:
            self.ctl.record_first_read(bkey, ctx.region, ctx.size,
                                       remote=not ctx.hit)

    def cache_on_read(self, ctx: GetContext) -> bool:
        return True

    def ttl_on_access(self, ctx, holders) -> float:
        """min over incoming edges from replica-holding regions, with the
        eviction-safety filter of §3.3.1: ignore a source whose own replica
        will already be gone when our TTL expires (``holders`` maps region ->
        expire time; pinned/base replicas report inf)."""
        bkey = self._bkey(ctx.bucket, ctx.size)
        # One cached table lookup instead of per-holder edge_ttl calls --
        # identical values and identical refresh timing by the
        # edge_ttl_table contract (edge TTLs are constant between
        # refreshes).
        tbl = self.ctl.edge_ttl_table(bkey, ctx.region, ctx.now)
        edge = {s: tbl[s] for s in holders if s != ctx.region}
        if not edge:
            return INF
        expires = holders if isinstance(holders, dict) else {s: INF for s in edge}
        safe = {
            s: t for s, t in edge.items()
            if expires.get(s, INF) >= ctx.now + t
        }
        pool = safe or {
            s: t for s, t in edge.items() if expires.get(s, INF) == INF
        } or edge
        return float(min(pool.values()))

    def periodic(self, now: float, sim) -> None:
        # Refresh the `last` histograms from the simulator's last-access maps
        # (the §4.2 "background process ... once per day").
        for (bucket, region), entries in sim.last_access_snapshot().items():
            if not entries:
                continue
            groups: dict = {}
            for (t, s) in entries.values():
                groups.setdefault(self._bkey(bucket, s), []).append((t, s))
            for bkey, vals in groups.items():
                ages = [now - t for (t, _s) in vals]
                sizes = [_s for (_t, _s) in vals]
                self.ctl.set_last_snapshot(bkey, region, ages, sizes)


# ---------------------------------------------------------------------------
# Latency SLO
# ---------------------------------------------------------------------------

class LatencySLO(Policy):
    """Minimize cost subject to a p99 GET-latency SLO (§6.3).

    Three levers, all driven by the shared :class:`CostModel` latency
    formula so both planes decide identically:

      * **latency-aware routing** -- a non-zero ``latency_weight`` makes GET
        source selection score holders by
        ``egress_price + latency_weight * get_latency_ms`` instead of price
        alone, trading a pricier edge for a closer one;
      * **SLO-gated replicate-on-read** -- a miss is cached locally only
        when the edge it was served over breaches the SLO (a within-SLO
        remote read costs nothing extra to repeat);
      * **pre-replication toward hot readers** -- a PUT is pushed to regions
        that read this object often (``hot_gets`` observed GETs) *and* would
        breach the SLO reading from the landing region, so their next read
        is intra-region before it ever goes remote.

    Cached copies carry a finite T_even TTL (the §3.1.2 break-even bound),
    keeping the storage bill bounded; the SLO machinery only decides *where*
    copies appear, never pins them.

    All state is per-object read counters fed by ``observe_get`` -- both
    planes see the identical GetContext stream, so separate instances stay
    divergence-free by construction (iteration over hot readers is sorted;
    replaylint RS003).
    """

    name = "latency_slo"
    latency_weight = 1e-3   # 1 ms ~ $0.001 of egress when ranking sources

    def __init__(self, cost: CostModel, slo_ms: float = 100.0,
                 hot_gets: int = 3):
        super().__init__(cost)
        self.slo_ms = float(slo_ms)
        self.hot_gets = int(hot_gets)
        self._reads: Dict[Tuple[int, str], int] = {}
        self._hot: Dict[int, set] = {}

    def reset(self) -> None:
        self._reads.clear()
        self._hot.clear()

    def observe_get(self, ctx: GetContext) -> None:
        key = (ctx.obj, ctx.region)
        n = self._reads.get(key, 0) + 1
        self._reads[key] = n
        if n >= self.hot_gets:
            self._hot.setdefault(ctx.obj, set()).add(ctx.region)

    def _breaches(self, src: str, dst: str, size: float) -> bool:
        return self.cost.get_latency_ms(src, dst, size) > self.slo_ms

    def replicate_on_write(self, obj, bucket, region, size, now) -> List[str]:
        return [
            r for r in sorted(self._hot.get(obj, ()))
            if r != region and self._breaches(region, r, size)
        ]

    def cache_on_read(self, ctx: GetContext) -> bool:
        return self._breaches(ctx.src_region, ctx.region, ctx.size)

    def ttl_on_access(self, ctx, holders) -> float:
        srcs = [h for h in holders if h != ctx.region] or [ctx.src_region]
        return min(self.cost.t_even_seconds(s, ctx.region) for s in srcs)


#: Accepted spelling variants (paper text vs. registry names).
POLICY_ALIASES = {
    "teven": "t_even",
    "aws_multi_region": "aws_mrb",
}


#: Every registered policy, keyed by its canonical table name (the name the
#: golden-matrix fixtures and the paper tables use).
POLICY_REGISTRY = {
    "always_evict": AlwaysEvict,
    "always_store": AlwaysStore,
    "t_even": TevenPolicy,
    "ewma": EWMAPolicy,
    "ttl_cc": TTLCC,
    "ttl_cc_obj": TTLCCObj,
    "cgp": ClairvoyantGreedy,
    "spanstore": SPANStore,
    "skystore": SkyStorePolicy,
    "aws_mrb": aws_multi_region,
    "juicefs": juicefs,
    "latency_slo": LatencySLO,
}


def make_policy(name: str, cost: CostModel, device="cuda", **kw) -> Policy:
    """Build policy ``name``.  ``device`` ("cuda" by default) is checked
    for every policy -- a missing or pre-Hopper card raises rather than
    falling back -- and handed to the policies that run a kernel
    (SkyStore's TTL controller); pass ``device="cpu"`` for the CPU."""
    resolve_device(device)
    name = POLICY_ALIASES.get(name, name)
    factory = POLICY_REGISTRY.get(name)
    if factory is None:
        raise KeyError(
            f"unknown policy {name!r}; available: "
            f"{', '.join(sorted(POLICY_REGISTRY))} "
            f"(aliases: {', '.join(f'{a}->{c}' for a, c in sorted(POLICY_ALIASES.items()))})")
    if factory is SkyStorePolicy:
        kw["device"] = device
    return factory(cost, **kw)
