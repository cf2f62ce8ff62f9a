"""Differential trace replay: simulator vs. live plane, diffed (§3.2, §5).

The PyTorch port's copy of :mod:`repro.core.replay`.  SkyStore's evaluation
rests on a cost simulator whose routing semantics are claimed to match the
live serving path; both share one op language (:mod:`repro_torch.core.api`),
and this module *verifies* the claim: the same
:class:`~repro_torch.core.traces.Trace` is pushed through

  * the :class:`~repro_torch.core.simulator.Simulator` (event-driven, sizes only),
  * a live :class:`~repro_torch.core.virtual_store.VirtualStore` over
    :class:`~repro_torch.core.backends.InMemoryBackend` regions, driven under
    virtual time with real bytes, the policy plugged into the live decision
    surface, and a :class:`~repro_torch.core.ledger.CostLedger` charging the same
    :class:`~repro_torch.core.costmodel.CostModel` per request,

and every observable is diffed: per-GET routing decisions (source region +
hit/miss + the policy's store/evict-now placement action), epoch-solver
replica-set changes (SPANStore), final replica holder sets,
op/hit/eviction/replication counters (exact), and dollar cost components
(storage / base storage / network / ops, to a relative tolerance).  Zero
divergence is the invariant every policy PR must preserve;
``tests/golden/replay/*.json`` pins the absolute numbers for the full
workload x policy evaluation matrix -- oracle baselines (CGP, SPANStore)
included: each plane derives an equivalent
:class:`~repro_torch.core.oracle.TraceOracle` from the same trace (the simulator
keyed by raw trace ids, the live plane by its interned ids), and the
decisions diff is what proves the two derivations agree.

Worked example -- one workload through both planes, by hand::

    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.replay import replay_differential
    from repro_torch.core.workloads import make_workload

    cost = pick_regions(3)                              # 3-region catalog
    trace = make_workload("zipfian", cost.region_names(), seed=7)
    r = replay_differential(trace, cost, "cgp", device="cpu")  # sim + live + diff
    assert r.ok()                                       # zero divergence
    print(r.summary_line())                             # one-line verdict
    print(r.sim_costs["total"], r.live_costs["total"])  # identical bills

Under the hood that call (a) runs the event-driven Simulator over the
trace, (b) rebuilds the same trace against a live VirtualStore over
in-memory region backends -- real bytes, a CostLedger charging the same
CostModel, the policy plugged into the live decision surface, and (for
``requires_oracle`` policies) a TraceOracle precomputed from the trace --
then (c) diffs every observable listed above.  Both planes drain one
:class:`~repro_torch.core.engine.EventSpine` schedule, so expirations, scan
ticks, and epoch boundaries interleave identically by construction.

``device`` ("cuda" by default) is where both planes' policies -- SkyStore's
TTL controllers, the policy's and the live metadata server's -- run their
kernel; a missing or pre-Hopper card raises.  ``device="cpu"`` runs on the
CPU.  The port reads the reference's fixtures and never writes them.

CLI::

    PYTHONPATH=src python -m repro_torch.core.replay --device cpu               # run + table
    PYTHONPATH=src python -m repro_torch.core.replay --check-golden --device cpu  # drift gate
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .api import ApiError, GetRequest, PutRequest
from .backends import HeadResult, InMemoryBackend
from .costmodel import CostModel, pick_regions
from .engine import (
    DATA, EPOCH, EXPIRE, REGION_DOWN, REGION_UP, TICK, EventSpine,
    OutageSchedule,
)
from .ledger import CostLedger, CostReport
from .metadata import COMMITTED, MetadataServer
from .oracle import TraceOracle
from .policies import make_policy
from .routing import VEC_ROUTE_MIN
from .simulator import Simulator
from .traces import Trace
from .virtual_store import VirtualStore
from .workloads import make_outage_schedule, make_workload

DAY = 24 * 3600.0

#: Default cross-plane cost agreement tolerance (relative).
COST_RTOL = 1e-6
#: Golden-fixture regression tolerance (same machine class, tighter).
GOLDEN_RTOL = 1e-9

#: The full workload x policy evaluation matrix pinned by the golden
#: regression suite: every policy of the paper's comparison table (§6.2.2)
#: -- clairvoyant oracles (cgp, spanstore) and replicate-on-write commercial
#: stand-ins (aws_mrb, juicefs) included, plus the §6.3 latency_slo policy
#: -- on every synthetic workload shape.  5 workloads x 12 policies = 60
#: fixtures, all zero-divergence.
GOLDEN_POLICIES = ("always_evict", "always_store", "t_even", "ewma",
                   "ttl_cc", "ttl_cc_obj", "skystore", "cgp", "spanstore",
                   "aws_mrb", "juicefs", "latency_slo")
GOLDEN_WORKLOADS = ("zipfian", "hotspot_shift", "write_heavy", "diurnal",
                    "scan_backup")
GOLDEN_SEED = 7

#: The §6.4 chaos extension of the golden matrix: every outage profile
#: (repro_torch.core.workloads.make_outage_schedule) x four representative
#: policies -- trivial single-copy (worst availability), the paper's
#: adaptive policy, a clairvoyant oracle, and the epoch solver -- on the
#: zipfian workload.  3 x 4 = 12 outage-bearing zero-divergence fixtures;
#: every fixture additionally pins the availability metric.
GOLDEN_OUTAGE_PROFILES = ("single", "rolling", "flaky")
GOLDEN_OUTAGE_POLICIES = ("always_evict", "skystore", "cgp", "spanstore")
GOLDEN_OUTAGE_WORKLOAD = "zipfian"


# ---------------------------------------------------------------------------
# Diff result
# ---------------------------------------------------------------------------

def rel_delta(a: float, b: float) -> float:
    m = max(abs(a), abs(b))
    return abs(a - b) / m if m > 0 else 0.0


@dataclasses.dataclass
class DiffReport:
    """Everything the two planes disagreed on (ideally: nothing)."""

    policy: str
    workload: str
    mode: str
    n_events: int
    n_get_checked: int
    placement_mismatches: List[dict]
    holder_mismatches: List[dict]
    counter_diffs: Dict[str, Tuple[int, int]]       # name -> (sim, live)
    sim_costs: Dict[str, float]
    live_costs: Dict[str, float]
    sim_counters: Dict[str, int]
    #: §6.4 chaos runs only: the outage profile name and the availability
    #: metric ({gets_served, gets_unavailable, deferred_syncs,
    #: fraction_served}, agreed by both planes).  Empty/None on outage-free
    #: runs so the pre-chaos fixtures stay byte-identical.
    outage: str = ""
    availability: Optional[Dict[str, float]] = None
    #: §6.3 latency-tracked runs only: per-plane p50/p90/p99/mean GET and
    #: PUT latency ({"sim": stats, "live": stats, "max_rel_delta": float}).
    #: None when latency tracking is off, so the pre-latency fixtures stay
    #: byte-identical (the same emit-when-present pattern as
    #: ``availability``).
    latency: Optional[Dict] = None
    #: The two planes' runs (sim, live) the report was diffed from; never
    #: serialized.
    planes: Optional[Tuple["PlaneRun", "PlaneRun"]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_placement_divergence(self) -> int:
        return len(self.placement_mismatches)

    @property
    def n_holder_divergence(self) -> int:
        return len(self.holder_mismatches)

    @property
    def max_rel_cost_delta(self) -> float:
        return max(
            (rel_delta(self.sim_costs[k], self.live_costs[k])
             for k in self.sim_costs),
            default=0.0,
        )

    def ok(self, tol: float = COST_RTOL) -> bool:
        return (not self.placement_mismatches
                and not self.holder_mismatches
                and not self.counter_diffs
                and self.max_rel_cost_delta <= tol
                and (self.latency is None
                     or self.latency["max_rel_delta"] <= tol))

    def to_json(self) -> dict:
        out = {
            "policy": self.policy,
            "workload": self.workload,
            "mode": self.mode,
            "n_events": self.n_events,
            "n_get_checked": self.n_get_checked,
            "divergence": {
                "placement": self.n_placement_divergence,
                "holders": self.n_holder_divergence,
                "counters": len(self.counter_diffs),
            },
            "max_rel_cost_delta": self.max_rel_cost_delta,
            "sim": self.sim_costs,
            "live": self.live_costs,
            "counters": self.sim_counters,
        }
        if self.outage:
            # Chaos fixtures carry the outage identity and the §6.4
            # availability metric; outage-free fixtures keep the pre-chaos
            # schema byte-for-byte.
            out["outage"] = self.outage
            out["availability"] = self.availability
        if self.latency is not None:
            # Latency-tracked runs carry the §6.3 differential latency
            # stats; untracked fixtures keep the pre-latency schema
            # byte-for-byte.
            out["latency"] = self.latency
        return out

    def summary_line(self) -> str:
        status = "OK " if self.ok() else "DIVERGED"
        label = (f"{self.workload}@{self.outage}" if self.outage
                 else self.workload)
        avail = (f" served={self.availability['fraction_served']:.3f}"
                 if self.availability is not None else "")
        if self.latency is not None:
            avail += (f" get_p99={self.latency['sim'].get('get_p99', 0.0):.1f}ms"
                      f" lat_delta={self.latency['max_rel_delta']:.2e}")
        return (f"{status} {label:14s} {self.policy:13s} "
                f"mode={self.mode} gets={self.n_get_checked} "
                f"placement_diff={self.n_placement_divergence} "
                f"holder_diff={self.n_holder_divergence} "
                f"counter_diff={len(self.counter_diffs)} "
                f"max_rel_cost_delta={self.max_rel_cost_delta:.2e} "
                f"sim_total=${self.sim_costs['total']:.6f}{avail}")


# ---------------------------------------------------------------------------
# Plane runners
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlaneRun:
    """Everything one plane's replay produced, in diffable form."""

    report: CostReport
    #: (t, oid, region, src_region, hit, action) per GET -- routing plus the
    #: policy's store/evict-now placement choice.
    decisions: List[Tuple]
    #: {oid: sorted committed-replica regions} at the horizon.
    holders: Dict
    #: (epoch_idx, t, {bucket: replica set}) per epoch-solver run
    #: (empty unless the policy defines ``epoch``, i.e. SPANStore).
    epoch_sets: List[Tuple[int, float, Dict[str, Tuple[str, ...]]]]
    #: What decided: the plane's policy, and for the live plane its metadata
    #: server (both may hold a TTL controller whose refreshes can be read
    #: off afterwards, e.g. to count kernel launches).
    deciders: List = dataclasses.field(default_factory=list)


def run_sim_plane(
    trace: Trace, cost: CostModel, policy_name: str, mode: str = "FB",
    scan_interval: float = DAY, outages: Optional[OutageSchedule] = None,
    routing: str = "auto", track_latency: bool = False, device="cuda",
    **policy_kw,
) -> PlaneRun:
    policy = make_policy(policy_name, cost, device=device, **policy_kw)
    sim = Simulator(cost, policy, mode=mode, scan_interval=scan_interval,
                    track_decisions=True, outages=outages, routing=routing,
                    track_latency=track_latency)
    report = sim.run(trace)
    return PlaneRun(report, sim.decisions, sim.replica_holders(),
                    sim.epoch_sets, [policy])


class _ReplayBackend(InMemoryBackend):
    """InMemoryBackend with the ETag digest memoized by body identity.

    The replay driver materializes simulated PUT bodies from a per-size
    cache (see ``_drive_live_spine``), and ``InMemoryBackend`` stores /
    returns ``bytes`` objects without copying -- so the same body object
    flows driver -> put -> get -> replication put.  Digesting it once per
    object identity removes md5 (~13% of live replay time) from the hot
    path while producing the identical ETag strings; the memo holds a
    strong reference to each body, which is what keeps ``id()`` keys
    stable."""

    def __init__(self, region: str):
        super().__init__(region)
        self._etags: Dict[int, Tuple[bytes, str]] = {}

    def put(self, bucket, key, data):
        memo = self._etags.get(id(data))
        if memo is not None and memo[0] is data:
            h = HeadResult(key, len(data), memo[1], self._stamp())
            self._data[(bucket, key)] = (data, h)
            self.op_counts["put"] += 1
            self.bytes_in += len(data)
            return h
        h = super().put(bucket, key, data)
        self._etags[id(data)] = (data, h.etag)
        return h


def _make_live_plane(
    trace: Trace, cost: CostModel, policy_name: str, mode: str,
    backends: Optional[Dict], routing: str = "auto",
    track_latency: bool = False, device="cuda", **policy_kw,
):
    """Build the policy-driven live stack for one replay: store + ledger +
    policy, with a trace-backed :class:`~repro_torch.core.oracle.TraceOracle`
    attached through ``VirtualStore(oracle=...)`` whenever the policy is
    clairvoyant (``requires_oracle`` -- CGP's next-GET lookahead, SPANStore's
    per-epoch workload summaries).  The policy, the metadata server and the
    store all take ``device``."""
    policy = make_policy(policy_name, cost, device=device, **policy_kw)
    mode = getattr(policy, "mode", None) or mode
    horizon = trace.duration
    policy.reset()
    ledger = CostLedger(cost, policy=policy.name, mode=mode, horizon=horizon,
                        track_latency=track_latency)
    meta = MetadataServer(cost, mode=mode, versioning=False, ledger=ledger,
                          routing=routing, device=device)
    # Key the oracle by the metadata server's interned ids -- identical to
    # the raw trace ids for numeric keys, and correct for traces whose
    # iter_requests rewrites keys to arbitrary strings.
    oracle = (TraceOracle.from_trace(trace, epoch_len=policy.epoch,
                                     interner=meta.interner)
              if policy.requires_oracle else None)
    if backends is None:
        backends = {r: _ReplayBackend(r) for r in cost.region_names()}
    store = VirtualStore(cost, backends, meta, mode=mode, policy=policy,
                         ledger=ledger, oracle=oracle, device=device)
    for bucket in trace.buckets:
        store.create_bucket(bucket)
    return store, ledger, policy, horizon


def _dispatch_live(store: VirtualStore, req, t: float,
                   decisions: List[Tuple], bodies: Optional[Dict] = None,
                   hints=None, k: int = -1) -> None:
    """One data event on the live plane: materialize simulated PUT bodies,
    dispatch, and record the per-GET routing decision (source region, hit,
    and the policy's placement action off the response).  The simulator
    silently skips requests at missing keys; a live error on the same event
    is a divergence to report, not a crash (hand-authored traces can
    violate the generator invariants).

    ``bodies`` caches one zero-filled body per distinct size, so every PUT
    of that size stores the *same* bytes object -- which is what lets
    :class:`_ReplayBackend` memoize the ETag digest by identity (and drops
    the per-PUT allocation).  ``hints``/``k`` forward the chunk's vectorized
    routing answers to :meth:`VirtualStore._handle_get`."""
    try:
        if type(req) is GetRequest:
            resp = store._handle_get(req, hints, k)
        else:
            if isinstance(req, PutRequest) and req.body is None:
                body = None if bodies is None else bodies.get(req.nbytes)
                if body is None:
                    body = b"\x00" * req.nbytes
                    if bodies is not None:
                        bodies[req.nbytes] = body
                req = dataclasses.replace(req, body=body, size=None)
            resp = store.dispatch(req)
    except ApiError as e:
        decisions.append((t, type(req).__name__, getattr(req, "region", None),
                          f"error:{e.code}", False, "error"))
        return
    if type(req) is GetRequest:
        decisions.append((t, store._obj_id(req.key), req.region,
                          resp.source_region, resp.hit,
                          resp.placement_action))


def _live_epoch(store: VirtualStore, policy, epoch: int, t: float,
                epoch_sets: List[Tuple]) -> None:
    """Epoch boundary on the live plane: feed the solver the upcoming
    epoch's workload off the shared oracle, apply the new replica sets, and
    record them for the epoch-set diff (``Simulator.run``'s EPOCH branch,
    mirrored)."""
    gets, puts = policy.oracle.epoch_summary(epoch)
    policy.solve_epoch(gets, puts)
    store.apply_replica_sets(policy.replica_sets, t)
    epoch_sets.append((epoch, t, dict(policy.replica_sets)))


def _drive_live_spine(store: VirtualStore, policy, trace: Trace,
                      scan_interval: float, horizon: float,
                      outages: Optional[OutageSchedule] = None,
                      ) -> Tuple[List[Tuple], List[Tuple]]:
    """Drain one :class:`~repro_torch.core.engine.EventSpine` through the live
    plane: expirations pop off the shared index (O(expired) per event)
    instead of a full eviction scan before every request, and §6.4 outage
    transitions flip the store's availability at the identical point in
    the stream the simulator sees them."""
    decisions: List[Tuple] = []
    epoch_sets: List[Tuple] = []
    spine = EventSpine(trace.iter_requests(), store.meta.expiry,
                       scan_interval=scan_interval, epoch_len=policy.epoch,
                       horizon=horizon, outages=outages)
    # Batched consumption (engine.py "batched consumption" contract) --
    # the same chunked loop Simulator.run drives, so both planes observe
    # the identical scalar-equivalent event order.
    expiry = store.meta.expiry
    expire_round = store.expire_replicas
    routing = store.meta.routing
    peek_oid = store.meta.interner.peek
    bodies: Dict[int, bytes] = {}
    for batch in spine.iter_batches():
        kind = batch.kind
        if kind == DATA:
            hints = None
            if routing is not None:
                gets = batch.gets()
                if len(gets) >= VEC_ROUTE_MIN:
                    # Unknown keys peek to None -> no row -> per-request
                    # scalar fallback inside _handle_get.
                    hints = routing.route_chunk(
                        [peek_oid(r.key) for r in gets],
                        [r.region for r in gets],
                        [r.at for r in gets])
            k = 0
            for req in batch.requests:
                t = float(req.at)
                p = expiry.peek()
                if p is not None and p <= t:
                    EventSpine.drain_due(expiry, t, expire_round)
                if type(req) is GetRequest:
                    _dispatch_live(store, req, t, decisions, bodies, hints, k)
                    k += 1
                else:
                    _dispatch_live(store, req, t, decisions, bodies)
        elif kind == EXPIRE:
            expire_round(batch.pops)
        elif kind == TICK:
            store.meta.expire_pending(batch.t)
            policy.periodic(batch.t, store)
        elif kind == REGION_DOWN:
            store.region_down(batch.region, batch.t)
        elif kind == REGION_UP:
            store.region_up(batch.region, batch.t)
        elif kind == EPOCH:
            _live_epoch(store, policy, batch.epoch, batch.t, epoch_sets)
    return decisions, epoch_sets


def run_live_plane(
    trace: Trace, cost: CostModel, policy_name: str, mode: str = "FB",
    scan_interval: float = DAY, backends: Optional[Dict] = None,
    outages: Optional[OutageSchedule] = None, routing: str = "auto",
    track_latency: bool = False, device="cuda", **policy_kw,
) -> PlaneRun:
    """Drive the live VirtualStore through the trace under virtual time.

    The trace drains through the same :class:`~repro_torch.core.engine.EventSpine`
    the simulator uses, so both planes pop expirations (and §6.4 outage
    transitions -- ``outages`` falls back to ``trace.outages``) in the
    identical order by construction.  Pass ``backends`` to inspect physical
    traffic counters afterwards."""
    store, ledger, policy, horizon = _make_live_plane(
        trace, cost, policy_name, mode, backends, routing=routing,
        track_latency=track_latency, device=device, **policy_kw)
    if outages is None:
        outages = trace.outages
    decisions, epoch_sets = _drive_live_spine(store, policy, trace,
                                              scan_interval, horizon, outages)
    report = ledger.finalize(horizon, store.meta)
    return PlaneRun(report, decisions, _live_holders(store.meta), epoch_sets,
                    [policy, store.meta])


def live_replay_throughput(
    trace: Trace, cost: CostModel, policy_name: str = "skystore",
    mode: str = "FB", scan_interval: float = DAY,
    outages: Optional[OutageSchedule] = None, routing: str = "auto",
    device="cuda", **policy_kw,
) -> Dict[str, float]:
    """Time one live-plane replay; returns events/sec plus the expiry-index
    counters the benchmark smoke guards on (the events/sec floor is the
    regression signal against O(objects) per-event work creeping back).
    ``outages`` (falling back to ``trace.outages``) times the replay under a
    §6.4 failure schedule -- the chaos-overhead benchmark."""
    store, ledger, policy, horizon = _make_live_plane(
        trace, cost, policy_name, mode, None, routing=routing, device=device,
        **policy_kw)
    if outages is None:
        outages = trace.outages
    t0 = time.perf_counter()
    _drive_live_spine(store, policy, trace, scan_interval, horizon, outages)
    dt = time.perf_counter() - t0
    report = ledger.finalize(horizon, store.meta)
    n = len(trace.events)
    return {
        "workload": trace.name,
        "policy": policy.name,
        "events": n,
        "seconds": dt,
        "events_per_sec": n / dt if dt > 0 else float("inf"),
        "expiry_pops": store.meta.expiry.n_pops,
        "expiry_stale": store.meta.expiry.n_stale,
        "total_cost": report.total,
    }


def _live_holders(meta: MetadataServer) -> Dict:
    out = {}
    for (_b, key), om in meta.objects.items():
        vm = om.latest
        if vm is None:
            continue
        regs = tuple(sorted(
            r for r, m in vm.replicas.items() if m.status == COMMITTED))
        if regs:
            out[meta.interner.intern(key)] = regs
    return out


# ---------------------------------------------------------------------------
# The differential driver
# ---------------------------------------------------------------------------

_COMPARED_COUNTERS = ("n_get", "n_put", "n_head", "n_list", "n_hit",
                      "n_miss", "n_evictions", "n_replications")


def replay_differential(
    trace: Trace, cost: CostModel, policy_name: str, mode: str = "FB",
    scan_interval: float = DAY, workload: str = "", max_mismatch_detail: int = 10,
    outages: Optional[OutageSchedule] = None, outage: str = "",
    routing: str = "auto", track_latency: bool = False, device="cuda",
    **policy_kw,
) -> DiffReport:
    """Replay ``trace`` through both planes and diff every observable.

    ``outages`` (falling back to ``trace.outages``) runs the §6.4 failure
    plane: both planes see the identical REGION_DOWN/REGION_UP stream, and
    the report additionally carries (and both planes must agree on) the
    availability metric -- fraction of GETs served vs. 503'd.

    ``track_latency`` turns on the §6.3 latency plane: both planes record
    per-GET/per-PUT latency from the one shared CostModel formula, and the
    report carries the differential p50/p90/p99/mean stats (exact stream
    identity is the invariant -- same decisions, same edges, same
    formula).

    ``device`` is where both planes' policies run their kernel; the
    report's ``planes`` holds the two :class:`PlaneRun` s (sim, live)."""
    if outages is None:
        outages = trace.outages
    sim = run_sim_plane(trace, cost, policy_name, mode, scan_interval,
                        outages=outages, routing=routing,
                        track_latency=track_latency, device=device,
                        **policy_kw)
    live = run_live_plane(trace, cost, policy_name, mode, scan_interval,
                          outages=outages, routing=routing,
                          track_latency=track_latency, device=device,
                          **policy_kw)
    sim_rep, sim_dec = sim.report, sim.decisions
    live_rep, live_dec = live.report, live.decisions

    placement: List[dict] = []
    n_checked = min(len(sim_dec), len(live_dec))
    if len(sim_dec) != len(live_dec):
        longer = sim_dec if len(sim_dec) > len(live_dec) else live_dec
        placement.append({"at": None, "why": "decision count",
                          "sim": len(sim_dec), "live": len(live_dec),
                          "unmatched": longer[n_checked:n_checked
                                              + max_mismatch_detail]})
    for i in range(n_checked):
        if sim_dec[i] != live_dec[i]:
            if len(placement) < max_mismatch_detail:
                t, oid, region, src, hit, action = sim_dec[i]
                _lt, _loid, _lregion, lsrc, lhit, laction = live_dec[i]
                placement.append({
                    "at": t, "obj": oid, "region": region,
                    "sim": {"src": src, "hit": hit, "action": action},
                    "live": {"src": lsrc, "hit": lhit, "action": laction},
                })
            else:
                placement.append({"at": sim_dec[i][0], "why": "elided"})

    # Epoch-solver replica-set changes (SPANStore): both planes must solve
    # the same sets at the same boundaries.  Mismatches are placement
    # divergence -- they land in the same list (and the same fixture
    # counter) as per-GET routing diffs.
    if sim.epoch_sets != live.epoch_sets:
        if len(sim.epoch_sets) != len(live.epoch_sets):
            placement.append({"at": None, "why": "epoch count",
                              "sim": len(sim.epoch_sets),
                              "live": len(live.epoch_sets)})
        for se, le in zip(sim.epoch_sets, live.epoch_sets):
            if se != le and len(placement) < max_mismatch_detail:
                placement.append({"at": se[1], "why": "epoch replica sets",
                                  "epoch": se[0],
                                  "sim": se[2], "live": le[2]})

    holder_mismatches: List[dict] = []
    for oid in sorted(set(sim.holders) | set(live.holders), key=str):
        a, b = sim.holders.get(oid), live.holders.get(oid)
        if a != b and len(holder_mismatches) < max_mismatch_detail:
            holder_mismatches.append({"obj": oid, "sim": a, "live": b})

    counter_diffs = {
        k: (sim_rep.counters()[k], live_rep.counters()[k])
        for k in _COMPARED_COUNTERS
        if sim_rep.counters()[k] != live_rep.counters()[k]
    }
    # §6.4 counters live outside CostReport.counters() (the pre-chaos
    # fixtures pin that dict byte-for-byte) but are part of the
    # differential contract all the same.
    for k in ("n_unavailable", "n_deferred_syncs"):
        a, b = getattr(sim_rep, k), getattr(live_rep, k)
        if a != b:
            counter_diffs[k] = (a, b)

    latency = None
    if track_latency:
        s_stats, l_stats = sim_rep.latency_stats(), live_rep.latency_stats()
        latency = {
            "sim": s_stats,
            "live": l_stats,
            "max_rel_delta": max(
                (rel_delta(s_stats.get(k, 0.0), l_stats.get(k, 0.0))
                 for k in sorted(set(s_stats) | set(l_stats))),
                default=0.0),
        }

    return DiffReport(
        policy=sim_rep.policy,
        workload=workload or trace.name,
        mode=sim_rep.mode,
        n_events=len(trace.events),
        n_get_checked=n_checked,
        placement_mismatches=placement,
        holder_mismatches=holder_mismatches,
        counter_diffs=counter_diffs,
        sim_costs=sim_rep.components(),
        live_costs=live_rep.components(),
        sim_counters=sim_rep.counters(),
        outage=outage,
        availability=(sim_rep.availability() if outages is not None
                      and len(outages) else None),
        latency=latency,
        planes=(sim, live),
    )


# ---------------------------------------------------------------------------
# Golden-cost regression fixtures
# ---------------------------------------------------------------------------

def golden_path(golden_dir: str, workload: str, policy: str,
                outage: str = "") -> str:
    """Fixture path: ``<workload>__<policy>.json``, or
    ``<workload>@<outage>__<policy>.json`` for the §6.4 chaos matrix."""
    wl = f"{workload}@{outage}" if outage else workload
    return os.path.join(golden_dir, f"{wl}__{policy}.json")


def run_golden_matrix(
    policies: Sequence[str] = GOLDEN_POLICIES,
    workloads: Sequence[str] = GOLDEN_WORKLOADS,
    seed: int = GOLDEN_SEED,
    n_regions: int = 3,
    device="cuda",
) -> List[DiffReport]:
    cost = pick_regions(n_regions)
    out = []
    for wl in workloads:
        trace = make_workload(wl, cost.region_names(), seed=seed)
        for pol in policies:
            out.append(replay_differential(trace, cost, pol, workload=wl,
                                           device=device))
    return out


def run_outage_matrix(
    policies: Sequence[str] = GOLDEN_OUTAGE_POLICIES,
    profiles: Sequence[str] = GOLDEN_OUTAGE_PROFILES,
    workload: str = GOLDEN_OUTAGE_WORKLOAD,
    seed: int = GOLDEN_SEED,
    n_regions: int = 3,
    device="cuda",
) -> List[DiffReport]:
    """The §6.4 chaos matrix: outage profiles x representative policies on
    one workload, every pair zero-divergence with the availability metric
    pinned."""
    cost = pick_regions(n_regions)
    trace = make_workload(workload, cost.region_names(), seed=seed)
    out = []
    for prof in profiles:
        sched = make_outage_schedule(prof, cost.region_names(),
                                     trace.duration, seed=seed)
        for pol in policies:
            out.append(replay_differential(trace, cost, pol, workload=workload,
                                           outages=sched, outage=prof,
                                           device=device))
    return out


def check_golden(reports: List[DiffReport], golden_dir: str,
                 rtol: float = GOLDEN_RTOL) -> List[str]:
    """Compare fresh reports against checked-in fixtures; returns a list of
    human-readable problems (empty = green)."""
    problems = []
    for r in reports:
        label = f"{r.workload}@{r.outage}" if r.outage else r.workload
        p = golden_path(golden_dir, r.workload, r.policy, r.outage)
        if not os.path.exists(p):
            problems.append(f"missing fixture {p}")
            continue
        with open(p) as f:
            want = json.load(f)
        got = r.to_json()
        for plane in ("sim", "live"):
            for k, v in want[plane].items():
                if rel_delta(v, got[plane][k]) > rtol:
                    problems.append(
                        f"{label}/{r.policy}: {plane}.{k} drifted "
                        f"{v} -> {got[plane][k]}")
        if got["counters"] != want["counters"]:
            problems.append(f"{label}/{r.policy}: counters drifted "
                            f"{want['counters']} -> {got['counters']}")
        if want.get("availability") is not None:
            a, b = want["availability"], got.get("availability") or {}
            for k, v in a.items():
                if k not in b or rel_delta(v, b[k]) > rtol:
                    problems.append(
                        f"{label}/{r.policy}: availability.{k} drifted "
                        f"{v} -> {b.get(k)}")
        if want.get("latency") is not None:
            lw, lg = want["latency"], got.get("latency") or {}
            for plane in ("sim", "live"):
                a, b = lw.get(plane) or {}, lg.get(plane) or {}
                for k, v in a.items():
                    if k not in b or rel_delta(v, b[k]) > rtol:
                        problems.append(
                            f"{label}/{r.policy}: latency.{plane}.{k} "
                            f"drifted {v} -> {b.get(k)}")
        if not r.ok():
            problems.append(f"{label}/{r.policy}: planes diverged: "
                            f"{r.summary_line()}")
    return problems


def default_golden_dir() -> str:
    """tests/golden/replay, resolved relative to the repo root."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return os.path.join(root, "tests", "golden", "replay")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Differential trace replay: Simulator vs live VirtualStore")
    ap.add_argument("--check-golden", action="store_true",
                    help="fail (exit 1) if fresh runs drift from fixtures "
                         "(read only: the port never writes them)")
    ap.add_argument("--golden-dir", default=default_golden_dir())
    ap.add_argument("--policies", nargs="*", default=list(GOLDEN_POLICIES))
    ap.add_argument("--workloads", nargs="*", default=list(GOLDEN_WORKLOADS))
    ap.add_argument("--outage-profiles", nargs="*",
                    default=list(GOLDEN_OUTAGE_PROFILES),
                    help="§6.4 chaos matrix profiles (empty list to skip)")
    ap.add_argument("--outage-policies", nargs="*",
                    default=list(GOLDEN_OUTAGE_POLICIES))
    ap.add_argument("--skip-outages", action="store_true",
                    help="run only the outage-free matrix")
    ap.add_argument("--skip-baseline", action="store_true",
                    help="run only the §6.4 chaos matrix")
    ap.add_argument("--seed", type=int, default=GOLDEN_SEED)
    ap.add_argument("--regions", type=int, default=3, choices=(3, 6, 9))
    ap.add_argument("--device", default="cuda",
                    help="where the policies' kernels run: cuda (default; "
                         "raises without a Hopper card) or cpu")
    args = ap.parse_args(argv)

    reports = []
    if not args.skip_baseline:
        reports += run_golden_matrix(args.policies, args.workloads, args.seed,
                                     args.regions, device=args.device)
    if not args.skip_outages and args.outage_profiles:
        reports += run_outage_matrix(args.outage_policies,
                                     args.outage_profiles,
                                     seed=args.seed, n_regions=args.regions,
                                     device=args.device)
    for r in reports:
        print(r.summary_line())
    diverged = [r for r in reports if not r.ok()]

    if args.check_golden:
        problems = check_golden(reports, args.golden_dir)
        for p in problems:
            print("DRIFT:", p)
        if problems:
            return 1
    if diverged:
        print(f"{len(diverged)} policy/workload pairs diverged")
        return 1
    print(f"all {len(reports)} policy/workload pairs agree "
          f"(placement exact, costs within {COST_RTOL:g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
