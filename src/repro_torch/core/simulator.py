"""Event-driven monetary-cost simulator (paper §5 "1.9k lines of Python to
estimate the total cost of each of these policies across traces").

Trace replay drives the *same* typed request objects
(:class:`~repro_torch.core.api.PutRequest` / ``GetRequest`` / ``DeleteObjectRequest``)
as the live :class:`~repro.core.virtual_store.VirtualStore`, through the same
``dispatch(op)`` entry point, and GET routing / PUT base-pinning come from the
shared helpers in :mod:`repro_torch.core.api` -- so the cost model cannot silently
diverge from serving semantics.

The simulator owns the mechanics every policy shares:

  * write-local PUTs (optionally sync-replicated to the FB base on cross-region
    overwrite, matching §4.4 last-writer-wins semantics);
  * GETs served from the cheapest replica-holding region (§2.3), charged the
    edge's egress price on a miss;
  * replicate-on-read (if the policy says so) and TTL bookkeeping with reset-
    on-access (§3.2.1), via a lazy expiration heap;
  * FB/FP invariants: the base replica is pinned; the sole remaining FP copy
    is never evicted (its expiry is re-armed);
  * storage accounting integrated per replica lifetime [start, evict), capped
    at the trace horizon so infinite-TTL policies remain finite;
  * per-GET latency estimates from the cost model (Table 6);
  * oracle precomputation for CGP and the SPANStore epoch solver.

Traces are numpy structured arrays (see :mod:`repro_torch.core.traces`).

This is the PyTorch port's copy of :mod:`repro.core.simulator`; it decides
exactly as the reference does, so the golden replay fixtures pin it too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .api import (
    ApiError,
    DeleteObjectRequest,
    GetRequest,
    HeadRequest,
    ListRequest,
    PutRequest,
    Request,
    choose_get_source,
    resolve_put_placement,
    resolve_put_region,
)
from .costmodel import GB, SECONDS_PER_MONTH, CostModel
from .engine import (
    DATA, EPOCH, EXPIRE, REGION_DOWN, REGION_UP, TICK, EventSpine,
    OutageSchedule,
)
from .expiry import ExpiryIndex
from .ledger import CostReport
from .oracle import TraceOracle
from .policies import GetContext, Oracle, Policy
from .routing import (
    ROUTE_OK, ROUTE_UNAVAILABLE, VEC_ROUTE_MIN, RouteHints, RoutingMatrix,
    resolve_routing_engine,
)
INF = float("inf")
_NEG_INF = float("-inf")


@dataclasses.dataclass
class Replica:
    region: str
    start: float
    last_access: float
    ttl: float
    expire: float
    pinned: bool = False


@dataclasses.dataclass
class ObjectState:
    size: float
    bucket: str
    base_region: Optional[str]
    replicas: Dict[str, Replica]
    version: int = 0


class Simulator:
    def __init__(
        self,
        cost: CostModel,
        policy: Policy,
        mode: str = "FB",
        scan_interval: float = 24 * 3600.0,
        charge_ops: bool = True,
        track_latency: bool = False,
        track_decisions: bool = False,
        min_fp_copies: int = 1,
        outages: Optional[OutageSchedule] = None,
        routing: str = "auto",
    ) -> None:
        if mode not in ("FB", "FP"):
            raise ValueError("mode must be FB or FP")
        self.cost = cost
        self.policy = policy
        self.mode = getattr(policy, "mode", mode) if getattr(policy, "mode", None) else mode
        self.scan_interval = scan_interval
        self.charge_ops = charge_ops
        self.track_latency = track_latency
        #: §6.3 latency-vs-egress routing knob, owned by the policy (the
        #: latency_slo family sets it; stock policies leave it 0.0, keeping
        #: the price-only decision stream bit-identical to the pre-latency
        #: plane).  Read by both the scalar oracle call and the matrix.
        self.latency_weight = float(getattr(policy, "latency_weight", 0.0))
        self.track_decisions = track_decisions
        #: (t, oid, landing region, source region, hit, action) per GET, for
        #: the differential replay harness (repro.core.replay).  ``action``
        #: is the policy's post-GET placement choice -- "store"/"skip" on a
        #: miss, "keep"/"evict" on a hit -- so clairvoyant store/evict-now
        #: decisions (CGP, §3.1.1) are diffed, not just routing.
        self.decisions: List[Tuple[float, int, str, str, bool, str]] = []
        #: (epoch_idx, t, {bucket: replica set}) per epoch-solver run
        #: (SPANStore §6.2.2) -- the per-epoch replica-set changes the
        #: replay harness diffs against the live plane.
        self.epoch_sets: List[Tuple[int, float, Dict[str, Tuple[str, ...]]]] = []
        self.min_fp_copies = min_fp_copies

        #: §6.4 failure plane: the outage schedule compiled into the spine
        #: (``run`` falls back to ``trace.outages`` when None).
        self.outages = outages
        #: Regions currently inside an outage window -- consulted by GET
        #: routing, PUT redirect, replication-target gating, and the
        #: reachable-copy expiry guard.
        self.unavailable: set = set()
        #: §4.4 syncs deferred past a base-region outage: oid -> the
        #: write-local landing region, replayed at REGION_UP.
        self._pending_sync: Dict[int, str] = {}

        self.objects: Dict[int, ObjectState] = {}
        #: The shared §3.2 lazy expiration heap (same class -- and thus the
        #: same (expire, oid, region) pop order -- as the live MetadataServer).
        self.expiry = ExpiryIndex()
        self._last_get: Dict[Tuple[int, str], float] = {}
        # (bucket, region) -> {obj: (last_get_time, size)} with no later GET yet
        self._open_last: Dict[Tuple[str, str], Dict[int, Tuple[float, float]]] = {}
        self.report = CostReport(policy.name, self.mode)
        self._horizon = 0.0
        #: Vectorized GET routing (repro_torch.core.routing): dense holder/expiry
        #: arrays mirroring ``objects``, kept in sync by the replica
        #: lifecycle below.  ``routing="python"`` pins the scalar
        #: ``choose_get_source`` oracle (decision-identical by contract;
        #: tests diff whole replays across the two engines).
        self._routing_engine = resolve_routing_engine(routing)
        self.routing: Optional[RoutingMatrix] = (
            RoutingMatrix(cost, latency_weight=self.latency_weight)
            if self._routing_engine == "matrix" else None
        )

    # -- accounting -------------------------------------------------------------
    def _charge_storage(self, obj: ObjectState, rep: Replica, end: float) -> None:
        end = min(end, self._horizon) if self._horizon else end
        c = self.cost.storage_cost(rep.region, obj.size, end - rep.start)
        if rep.pinned:
            self.report.storage_base += c
        else:
            self.report.storage += c

    def _charge_transfer(self, src: str, dst: str, size: float) -> None:
        self.report.network += self.cost.transfer_cost(src, dst, size)

    def _charge_op(self, region: str, op: str) -> None:
        if self.charge_ops:
            self.report.ops += self.cost.op_cost(region, op)

    # -- replica lifecycle ---------------------------------------------------------
    def _add_replica(
        self, oid: int, obj: ObjectState, region: str, now: float, ttl: float,
        pinned: bool = False,
    ) -> Replica:
        rep = obj.replicas.get(region)
        if rep is None:
            old = _NEG_INF
            rep = Replica(region, now, now, ttl, now + ttl, pinned)
            obj.replicas[region] = rep
        else:
            old = INF if rep.pinned else rep.expire
            rep.last_access, rep.ttl = now, ttl
            rep.expire = now + ttl
            rep.pinned = rep.pinned or pinned
        self.expiry.arm((oid, region), (oid, region),
                        INF if rep.pinned else rep.expire)
        if self.routing is not None:
            self.routing.set_replica(oid, region,
                                     INF if rep.pinned else rep.expire,
                                     obj.size, old=old)
        return rep

    def _drop_replica(self, oid: int, obj: ObjectState, region: str, now: float,
                      count_eviction: bool = False) -> None:
        rep = obj.replicas.pop(region, None)
        if rep is None:
            return
        self.expiry.disarm((oid, region))
        if self.routing is not None:
            self.routing.drop_replica(oid, region)
        self._charge_storage(obj, rep, now)
        if count_eviction:
            self.report.n_evictions += 1

    def _rearm(self, ident: Tuple[int, str], obj: ObjectState, rep: Replica,
               old: Optional[float] = None) -> None:
        """Re-schedule a surviving replica's expiry (``rep.expire`` already
        moved from ``old``; ``None`` = unknown, let the matrix read its own
        cell), keeping the routing matrix's expiry cell (and row version)
        in step with the index."""
        self.expiry.arm(ident, ident, rep.expire)
        if self.routing is not None:
            self.routing.set_replica(ident[0], ident[1], rep.expire, obj.size,
                                     old=old)

    def _expire_one(self, t: float, ident: Tuple[int, str]) -> None:
        """React to one expiry popped off the shared index (the spine's
        EXPIRE handler): drop the replica, or re-arm the sole FP copy."""
        oid, region = ident
        obj = self.objects.get(oid)
        rep = obj.replicas.get(region) if obj is not None else None
        if rep is None or rep.pinned:
            return
        if rep.expire > t:
            # Out-of-band mutation moved the expiry without re-arming
            # (cannot happen through _add_replica); restore the schedule.
            self._rearm(ident, obj, rep)
            return
        step = max(rep.ttl, 3600.0)
        if region in self.unavailable:
            # §6.4: the region is dark -- the physical delete cannot run.
            # Keep the replica (and keep paying its storage), stepping the
            # expiry until a pop lands after recovery.
            old = rep.expire
            rep.expire = t + step
            self._rearm(ident, obj, rep, old)
            return
        if self.mode == "FP" and len(obj.replicas) <= self.min_fp_copies:
            # Never evict the sole copy (§3.2.1) -- re-arm and keep paying.
            # If the new expiry is still due, the index pops it again within
            # the same drain (the old "re-arm until clear" loop).
            old = rep.expire
            rep.expire = t + step
            self._rearm(ident, obj, rep, old)
            return
        if self._sole_reachable(obj, region):
            # §6.4 reachable-copy guard: every sibling is in a downed
            # region, so dropping this replica would 503 the object for the
            # rest of the outage even though its data survives.  Refuse --
            # step the expiry exactly like the FP sole-copy guard.
            old = rep.expire
            rep.expire = t + step
            self._rearm(ident, obj, rep, old)
            return
        self._drop_replica(oid, obj, region, t, count_eviction=True)

    #: Drop count at which the per-round storage charges switch from scalar
    #: calls to one vectorized float64 tensor evaluation.  Both paths compute
    #: the identical IEEE-double products in the identical order, so the
    #: switch is invisible to the golden fixtures; below the threshold the
    #: tensor call overhead exceeds the arithmetic.
    _VEC_CHARGE_MIN = 8

    def _expire_batch(self, pops: List[Tuple[float, Tuple[int, str]]]) -> None:
        """React to one drain round off the shared index (the batched spine's
        EXPIRE handler).  Guard evaluation and replica-table mutation stay
        per-entry, *in pop order* -- later guards must observe earlier drops
        -- but the dropped replicas' storage charges are computed in one
        vectorized pass and accumulated in the same pop order, so the
        report's float trajectory is bit-identical to :meth:`_expire_one`
        called per entry."""
        drops: List[Tuple[ObjectState, Replica, float]] = []
        for texp, ident in pops:
            oid, region = ident
            obj = self.objects.get(oid)
            rep = obj.replicas.get(region) if obj is not None else None
            if rep is None or rep.pinned:
                continue
            if rep.expire > texp:
                self._rearm(ident, obj, rep)
                continue
            if (region in self.unavailable
                    or (self.mode == "FP"
                        and len(obj.replicas) <= self.min_fp_copies)
                    or self._sole_reachable(obj, region)):
                # The §6.4 / §3.2.1 guards of _expire_one, same order: the
                # replica survives, its expiry steps forward.
                old = rep.expire
                rep.expire = texp + max(rep.ttl, 3600.0)
                self._rearm(ident, obj, rep, old)
                continue
            obj.replicas.pop(region)
            self.expiry.disarm(ident)
            if self.routing is not None:
                self.routing.drop_replica(oid, region)
            self.report.n_evictions += 1
            drops.append((obj, rep, texp))
        if not drops:
            return
        if len(drops) < self._VEC_CHARGE_MIN:
            for obj, rep, texp in drops:
                self._charge_storage(obj, rep, texp)
            return
        horizon = self._horizon
        f64 = torch.float64
        end = torch.tensor([texp for _obj, _rep, texp in drops], dtype=f64)
        if horizon:
            end = end.clamp_max(horizon)
        start = torch.tensor([rep.start for _obj, rep, _texp in drops],
                             dtype=f64)
        size = torch.tensor([obj.size for obj, _rep, _texp in drops], dtype=f64)
        price = torch.tensor(
            [self.cost.storage_price(rep.region) for _obj, rep, _texp in drops],
            dtype=f64)
        # Elementwise mirror of CostModel.storage_cost -- same factors, same
        # association -- accumulated sequentially in pop order (a pairwise
        # reduction would round differently).
        costs = price * (size / GB) * ((end - start).clamp_min(0.0)
                                       / SECONDS_PER_MONTH)
        for c in costs.tolist():
            self.report.storage += c

    def _sole_reachable(self, obj: ObjectState, region: str) -> bool:
        """§6.4 guard predicate: is ``region``'s replica the object's last
        *reachable* copy while an outage is active?  Dropping it would 503
        the object for the rest of the outage (expiry path) or lose the
        newest version outright (a deferred-sync landing copy is sole and
        unpinned).  Always False with no outage in progress -- pre-chaos
        behaviour is untouched."""
        return bool(self.unavailable) and not any(
            r for r in obj.replicas
            if r != region and r not in self.unavailable)

    # -- policy-visible state ------------------------------------------------------
    def last_access_snapshot(self):
        return self._open_last

    def holders(self, obj: ObjectState) -> Dict[str, float]:
        return {
            r: (INF if rep.pinned else rep.expire)
            for r, rep in obj.replicas.items()
        }

    # -- the unified op entry point (ObjectStoreAPI over trace events) ------------
    def dispatch(self, op: Request):
        """Consume the same typed request objects as the live store.  Event
        time comes from ``op.at`` (trace replay is clocked externally)."""
        handler = self._HANDLERS.get(type(op))
        if handler is None:
            raise ApiError("InvalidRequest",
                           f"simulator does not model {type(op).__name__}")
        return getattr(self, handler)(op)

    # -- event handlers ------------------------------------------------------------
    def _handle_put(self, op: PutRequest):
        now, oid = float(op.at), int(op.key)
        size, bucket = float(op.nbytes), op.bucket
        obj = self.objects.get(oid)
        try:
            # §6.4: a PUT at a downed region redirects (live base first,
            # else cheapest live region); a full blackout 503s the PUT.
            region = resolve_put_region(
                op.region,
                obj.base_region if (obj is not None and self.mode == "FB")
                else None,
                self.unavailable, self.cost)
        except ApiError as e:
            if self.track_decisions:
                self.decisions.append((now, "PutRequest", op.region,
                                       f"error:{e.code}", False, "error"))
            return
        self._pending_sync.pop(oid, None)   # an overwrite re-decides the sync
        self.report.n_put += 1
        self._charge_op(region, "PUT")
        if obj is None:
            obj = ObjectState(size, bucket, None, {})
            self.objects[oid] = obj
        else:
            # New version: old copies become stale under LWW (§4.4).
            for r in list(obj.replicas):
                self._drop_replica(oid, obj, r, now)
        obj.size, obj.version = size, obj.version + 1

        if self.mode == "FB":
            placement = resolve_put_placement("FB", obj.base_region, region,
                                              self.unavailable)
            obj.base_region = placement.base_region   # §2.3: first write wins
            self._add_replica(oid, obj, region, now, INF,
                              pinned=placement.pinned)
            if placement.sync_to_base:
                # Sync replication to base keeps the pinned copy fresh (§4.4).
                self._charge_transfer(region, obj.base_region, size)
                self._charge_op(obj.base_region, "PUT")
                self.report.n_replications += 1
                self._add_replica(oid, obj, obj.base_region, now, INF, pinned=True)
                # The write-local copy is a cache replica: give it a policy TTL.
                ctx = GetContext(oid, bucket, region, obj.base_region, size, now,
                                 hit=True, gap=None)
                ttl = self.policy.ttl_on_access(ctx, self.holders(obj))
                if ttl <= 0:
                    self._drop_replica(oid, obj, region, now)
                else:
                    self._add_replica(oid, obj, region, now, ttl)
            elif placement.sync_deferred:
                # §6.4: the base is dark -- queue the §4.4 sync for replay
                # at REGION_UP.  The landing replica keeps an infinite TTL
                # meanwhile: it may be the newest version's only copy.
                self._pending_sync[oid] = region
                self.report.n_deferred_syncs += 1
        else:
            self._add_replica(oid, obj, region, now, INF, pinned=False)

        for target in self.policy.replicate_on_write(oid, bucket, region, size, now):
            if (target == region or target in obj.replicas
                    or target in self.unavailable):
                continue
            self._charge_transfer(region, target, size)
            self._charge_op(target, "PUT")
            self.report.n_replications += 1
            self._add_replica(oid, obj, target, now, INF)

        if self.track_latency:
            # The real PUT formula (TTFB + transfer + commit ack) from the
            # client's origin region into the effective landing region --
            # the live plane records the identical value at the mirrored
            # point in VirtualStore._policy_put.
            self.report.put_latency_ms.append(
                self.cost.put_latency_ms(op.region, region, size))

    def _handle_get(self, op: GetRequest, _hints: Optional[RouteHints] = None,
                    _k: int = -1):
        now, oid = float(op.at), int(op.key)
        region, bucket = op.region, op.bucket
        obj = self.objects.get(oid)
        if obj is None or not obj.replicas:
            return
        size = obj.size
        # Same §2.3 routing rule the metadata server uses for live GETs,
        # restricted to reachable regions (§6.4 failover).  When the chunk
        # was routed through the matrix, honor the hint while its row
        # version snapshot is still fresh (see repro_torch.core.routing,
        # "Staleness protocol"); otherwise fall back to the scalar oracle.
        hinted = False
        if _hints is not None:
            row = _hints.rows[_k]
            if row >= 0 and _hints.live_ver[row] == _hints.vers[_k]:
                st = _hints.status[_k]
                if st == ROUTE_OK:
                    src, hit = _hints.srcs[_k], _hints.hits[_k]
                    hinted = True
                elif st == ROUTE_UNAVAILABLE:
                    # Every holder is dark: the identical outcome (and
                    # decision tuple) the scalar ApiError branch records.
                    self.report.n_unavailable += 1
                    if self.track_decisions:
                        self.decisions.append(
                            (now, "GetRequest", region,
                             "error:ServiceUnavailable", False, "error"))
                    return
                # ROUTE_NO_KEY cannot hold on a fresh row while
                # obj.replicas is non-empty; fall through to the oracle.
        # Holder map, built at most once per GET: the scalar oracle needs it
        # for routing, the policy for ttl_on_access.  Nothing mutates the
        # replica table between the two reads, so sharing it is invisible.
        holders = None
        if not hinted:
            try:
                holders = self.holders(obj)
                src, hit = choose_get_source(holders, region, now,
                                             self.cost, self.unavailable,
                                             size, self.latency_weight)
            except ApiError as e:   # ServiceUnavailable: every holder is dark
                self.report.n_unavailable += 1
                if self.track_decisions:
                    # The identical tuple the live driver records for a
                    # failed dispatch, so 503s are part of the differential
                    # contract.
                    self.decisions.append((now, "GetRequest", region,
                                           f"error:{e.code}", False, "error"))
                return
        self.report.n_get += 1
        if hinted:
            # Chunk-vector charge, accumulated in event order: the hint's
            # op_cost element is the same IEEE double _charge_op would add.
            if self.charge_ops:
                self.report.ops += _hints.op_cost[_k]
        else:
            self._charge_op(region, "GET")
        gap_key = (oid, region)
        prev = self._last_get.get(gap_key)
        gap = (now - prev) if prev is not None else None
        ctx = GetContext(oid, bucket, region, src, size, now, hit, gap)
        self.policy.observe_get(ctx)
        self.report.n_hit += int(hit)
        self.report.n_miss += int(not hit)

        action = "skip"
        if not hit:
            # Failover egress: on an outage the cheapest *live* source may
            # be a pricier edge -- the extra network dollars are the §6.4
            # cost of availability, charged identically by both planes.
            if hinted:
                # Same discipline as op_cost above: egress[k] is the exact
                # transfer_cost product, computed as a chunk vector.
                self.report.network += _hints.egress[_k]
            else:
                self._charge_transfer(src, region, size)
            # A downed landing region cannot take the replicate-on-read
            # copy; the policy is not even consulted (both planes agree).
            if region not in self.unavailable and self.policy.cache_on_read(ctx):
                self.report.n_replications += 1
                ttl = self.policy.ttl_on_access(
                    ctx, holders if holders is not None else self.holders(obj))
                if ttl > 0:
                    self._add_replica(oid, obj, region, now, ttl)
                    action = "store"
        else:
            rep = obj.replicas[region]
            if not rep.pinned:
                ttl = self.policy.ttl_on_access(
                    ctx, holders if holders is not None else self.holders(obj))
                if (ttl <= 0
                        and (self.mode != "FP"
                             or len(obj.replicas) > self.min_fp_copies)
                        and not self._sole_reachable(obj, region)):
                    self._drop_replica(oid, obj, region, now, count_eviction=True)
                    action = "evict"
                else:
                    self._add_replica(oid, obj, region, now, ttl)
                    action = "keep"
            else:
                rep.last_access = now
                action = "keep"
        if self.track_decisions:
            self.decisions.append((now, oid, region, src, hit, action))

        self._last_get[gap_key] = now
        self._open_last.setdefault((bucket, region), {})[oid] = (now, size)
        if self.track_latency:
            self.report.get_latency_ms.append(self.cost.get_latency_ms(src, region, size))

    def _handle_delete(self, op: DeleteObjectRequest):
        now, oid = float(op.at), int(op.key)
        obj = self.objects.pop(oid, None)
        self._pending_sync.pop(oid, None)
        if obj is None:
            return
        # The issuing region pays the request charge (matches the live plane,
        # where the client-facing proxy in op.region serves the DELETE).
        region = op.region or obj.base_region or self.cost.region_names()[0]
        self._charge_op(region, "DELETE")
        for r in list(obj.replicas):
            self._drop_replica(oid, obj, r, now)

    def _handle_head(self, op: HeadRequest):
        """HEAD is control-plane only: a per-request charge at the issuing
        region, no data movement, no TTL reset (§4.2: reset-on-access is a
        *GET* semantic; metadata reads do not touch replicas).  A HEAD at a
        missing key is skipped uncharged, like GET (the live plane 404s
        before billing)."""
        if self.objects.get(int(op.key)) is None:
            return
        self.report.n_head += 1
        if op.region is not None:
            self._charge_op(op.region, "HEAD")

    def _handle_list(self, op: ListRequest):
        """LIST: charged in S3's PUT/COPY/POST/LIST request tier; served
        entirely from the metadata table (§4.2), so no transfer and no
        placement effect."""
        self.report.n_list += 1
        if op.region is not None:
            self._charge_op(op.region, "LIST")

    # -- main loop -------------------------------------------------------------------
    def run(self, trace) -> CostReport:
        """``trace`` is a :class:`repro_torch.core.traces.Trace`; its events replay
        as :mod:`repro_torch.core.api` request objects through :meth:`dispatch`,
        interleaved with timer/expiry events by the shared
        :class:`~repro_torch.core.engine.EventSpine` -- the same spine (and the
        same :class:`~repro_torch.core.expiry.ExpiryIndex` pop order) the live
        replay driver consumes."""
        ev = trace.events
        self._horizon = float(ev["t"][-1]) if len(ev) else 0.0
        self.policy.reset()
        self.unavailable.clear()
        self._pending_sync.clear()
        outages = (self.outages if self.outages is not None
                   else getattr(trace, "outages", None))
        # Clairvoyant policies get the same kind of trace-backed oracle the
        # live plane uses (repro_torch.core.oracle); epoch-solver policies
        # (SPANStore) additionally get the per-epoch workload summaries,
        # served through the oracle rather than a side table -- so any
        # policy that sets ``epoch`` gets an oracle here even if it left
        # ``requires_oracle`` False.
        epoch_len = self.policy.epoch
        if self.policy.requires_oracle or epoch_len is not None:
            self.policy.oracle = TraceOracle.from_trace(trace,
                                                        epoch_len=epoch_len)

        spine = EventSpine(trace.iter_requests(), self.expiry,
                           scan_interval=self.scan_interval,
                           epoch_len=epoch_len, horizon=self._horizon,
                           outages=outages)
        # Batched consumption (engine.py "batched consumption" contract):
        # DATA requests arrive in runs and EXPIRE pops in drain rounds; the
        # pre-dispatch peek below is the consumer obligation that keeps the
        # event order identical to the scalar spine.
        expiry = self.expiry
        expire_batch = self._expire_batch
        handlers = {cls: getattr(self, name)
                    for cls, name in self._HANDLERS.items()}
        # Fresh routing arrays per run: the matrix mirrors self.objects,
        # which this loop rebuilds from the trace.
        routing = self.routing
        if routing is not None:
            routing = self.routing = RoutingMatrix(
                self.cost, latency_weight=self.latency_weight)
        handle_get = self._handle_get
        for batch in spine.iter_batches():
            kind = batch.kind
            if kind == DATA:
                reqs = batch.requests
                hints = None
                if routing is not None:
                    gets = batch.gets()
                    if len(gets) >= VEC_ROUTE_MIN:
                        # Route the whole chunk's GETs in one masked argmin
                        # (chunk-formation-time snapshot; per-request
                        # freshness is re-checked inside _handle_get).
                        hints = routing.route_chunk(
                            [int(r.key) for r in gets],
                            [r.region for r in gets],
                            [r.at for r in gets])
                k = 0
                for req in reqs:
                    p = expiry.peek()
                    if p is not None and p <= req.at:
                        EventSpine.drain_due(expiry, float(req.at),
                                             expire_batch)
                    if type(req) is GetRequest:
                        handle_get(req, hints, k)
                        k += 1
                        continue
                    h = handlers.get(type(req))
                    if h is None:
                        raise ApiError(
                            "InvalidRequest",
                            f"simulator does not model {type(req).__name__}")
                    h(req)
            elif kind == EXPIRE:
                expire_batch(batch.pops)
            elif kind == TICK:
                self.policy.periodic(batch.t, self)
            elif kind == REGION_DOWN:
                self._region_down(batch.t, batch.region)
            elif kind == REGION_UP:
                self._region_up(batch.t, batch.region)
            elif kind == EPOCH:
                gets, puts = self.policy.oracle.epoch_summary(batch.epoch)
                self.policy.solve_epoch(gets, puts)
                self._apply_spanstore_sets(batch.t)
                self.epoch_sets.append(
                    (batch.epoch, batch.t, dict(self.policy.replica_sets)))

        for oid, obj in self.objects.items():
            for rep in obj.replicas.values():
                self._charge_storage(obj, rep, min(rep.expire, self._horizon))
        return self.report

    _HANDLERS = {
        PutRequest: "_handle_put",
        GetRequest: "_handle_get",
        DeleteObjectRequest: "_handle_delete",
        HeadRequest: "_handle_head",
        ListRequest: "_handle_list",
    }

    # -- §6.4 failure plane -----------------------------------------------------------
    def _region_down(self, t: float, region: str) -> None:
        self.unavailable.add(region)
        if self.routing is not None:
            self.routing.set_outage(region, True)
        self.policy.region_available(region, False, t)

    def _region_up(self, t: float, region: str) -> None:
        self.unavailable.discard(region)
        if self.routing is not None:
            self.routing.set_outage(region, False)
        self._drain_pending_syncs(t)
        self.policy.region_available(region, True, t)

    def _drain_pending_syncs(self, now: float) -> None:
        """Replay §4.4 base syncs deferred past an outage (every REGION_UP:
        the recovering region may be the missing base *or* the only live
        source of a pending object).  Processed in object-id order -- the
        live plane iterates its pending set by interned id, so both planes
        replicate in the same sequence."""
        for oid in sorted(self._pending_sync):
            landing = self._pending_sync[oid]
            obj = self.objects.get(oid)
            if obj is None or not obj.replicas:
                del self._pending_sync[oid]
                continue
            base = obj.base_region
            if base is None or base in self.unavailable:
                continue                    # base still dark: keep waiting
            if base in obj.replicas:
                del self._pending_sync[oid]  # a newer PUT already landed there
                continue
            holders = {r: e for r, e in self.holders(obj).items()
                       if r not in self.unavailable}
            if not holders:
                continue                    # sources dark: retry at next UP
            src = self.cost.cheapest_source(holders, base)
            self._charge_transfer(src, base, obj.size)
            self._charge_op(base, "PUT")
            self.report.n_replications += 1
            self._add_replica(oid, obj, base, now, INF, pinned=True)
            del self._pending_sync[oid]
            # The landing copy now demotes to a cache replica with a policy
            # TTL -- the synchronous §4.4 rule, applied at recovery time.
            rep = obj.replicas.get(landing)
            if (rep is not None and not rep.pinned
                    and landing not in self.unavailable):
                ctx = GetContext(oid, obj.bucket, landing, base, obj.size,
                                 now, hit=True, gap=None)
                ttl = self.policy.ttl_on_access(ctx, self.holders(obj))
                if ttl <= 0:
                    self._drop_replica(oid, obj, landing, now)
                else:
                    self._add_replica(oid, obj, landing, now, ttl)

    def replica_holders(self) -> Dict[int, Tuple[str, ...]]:
        """{oid: sorted committed-replica regions} -- the placement state the
        differential replay harness compares against the live metadata."""
        return {
            oid: tuple(sorted(obj.replicas))
            for oid, obj in self.objects.items() if obj.replicas
        }

    def _apply_spanstore_sets(self, now: float) -> None:
        """Epoch boundary: drop replicas outside the new solver sets (FP,
        >=1).  §6.4: replicas in downed regions cannot be deleted (the next
        boundary after recovery collects them), and the last reachable copy
        is never dropped."""
        for oid, obj in self.objects.items():
            rs = self.policy.replica_sets.get(obj.bucket)
            if not rs:
                continue
            keep = set(rs)
            for r in list(obj.replicas):
                if (r in keep or r in self.unavailable
                        or len(obj.replicas) <= self.min_fp_copies
                        or self._sole_reachable(obj, r)):
                    continue
                self._drop_replica(oid, obj, r, now, count_eviction=True)


def run_policy(trace, cost: CostModel, policy_name: str, mode: str = "FB",
               track_latency: bool = False, device="cuda",
               **policy_kw) -> CostReport:
    """Replay ``trace`` under policy ``policy_name``.  ``device`` is where
    the policy's kernels run ("cuda" by default; "cpu" to stay off the
    card)."""
    from .policies import make_policy

    policy = make_policy(policy_name, cost, device=device, **policy_kw)
    sim = Simulator(cost, policy, mode=mode, track_latency=track_latency)
    return sim.run(trace)


# ---------------------------------------------------------------------------
# Oracle construction (moved to repro_torch.core.oracle; wrapper kept for callers)
# ---------------------------------------------------------------------------

def build_oracle(trace) -> Oracle:
    """DEPRECATED: use :meth:`repro_torch.core.oracle.TraceOracle.from_trace`,
    which also carries per-GET sizes and optional epoch summaries."""
    return TraceOracle.from_trace(trace)
