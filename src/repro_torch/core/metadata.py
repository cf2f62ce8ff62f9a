"""SkyStore control plane: the metadata server (paper §4.2).

Tracks virtual buckets/objects, the mapping to physical replicas, versioning,
per-(bucket, region) access statistics, and the TTL-driven eviction scan.  The
data itself never flows through here (§4.2: "the control plane does not handle
actual object data").

Write protocol (§4.5): two-phase -- ``begin_upload`` logs the intent (replica
state ``PENDING``), the data plane writes to the physical store, and
``complete_upload`` commits; uncommitted mutations time out and roll back, so
a crashed proxy can never leave dangling metadata pointing at missing data.

Fault tolerance (§4.5): :meth:`backup` serializes the whole table into the
object layer itself; :meth:`restore` rebuilds it, and :meth:`reconcile` scans
physical stores to recover from an incomplete backup.

This is the PyTorch port's copy of :mod:`repro.core.metadata`.  The only
tensors it reaches are those of its :class:`AdaptiveTTLController`:
``device`` is where a controller built here runs its TTL kernel ("cuda" by
default; a missing or pre-Hopper card raises, never a quiet move to the CPU).
GET routing stays on float64 CPU tensors (:mod:`repro_torch.core.routing`).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

from .api import ApiError, choose_get_source, resolve_put_placement
from .costmodel import CostModel
from ..kernels.ops import resolve_device
from .expiry import ExpiryIndex, KeyInterner
from .ledger import CostLedger
from .routing import RoutingMatrix, resolve_routing_engine
from .ttl_policy import AdaptiveTTLController

PENDING, COMMITTED = "pending", "committed"


class ReplicaMeta:
    """One physical replica's control-plane record.

    ``ttl``, ``last_access`` and ``pinned`` are property-backed: the derived
    ``expire`` is what the shared :class:`~repro_torch.core.expiry.ExpiryIndex`
    orders on, so *any* mutation -- including tests force-expiring a replica
    by assigning ``rep.ttl = 1.0`` directly -- transparently reschedules the
    replica in the index (the superseded heap entry is invalidated via its
    generation token)."""

    __slots__ = ("region", "status", "created_at", "_last_access", "_ttl",
                 "_pinned", "etag", "size", "_index", "_ident", "_order",
                 "_routing", "_oid")

    def __init__(self, region: str, status: str, created_at: float,
                 last_access: float, ttl: float = float("inf"),
                 pinned: bool = False, etag: str = "", size: int = 0) -> None:
        self.region = region
        self.status = status
        self.created_at = created_at
        self._last_access = last_access
        self._ttl = ttl
        self._pinned = pinned
        self.etag = etag
        self.size = size
        self._index: Optional[ExpiryIndex] = None
        self._ident = None
        self._order = None
        self._routing = None
        self._oid = 0

    # -- expiry-index binding ------------------------------------------------
    def bind_index(self, index: ExpiryIndex, ident, order) -> None:
        """Attach this replica to the metadata server's shared expiry index;
        from here on every expiry-moving mutation re-arms its schedule."""
        self._index, self._ident, self._order = index, ident, order
        self._reindex()

    def bind_routing(self, matrix, oid: int) -> None:
        """Attach this replica to the server's :class:`~repro_torch.core.routing.
        RoutingMatrix`: its cell is written now and kept in sync by every
        expiry-moving mutation (the same ``_reindex`` funnel the expiry
        index rides), until :meth:`unbind_index` drops it."""
        self._routing, self._oid = matrix, oid
        matrix.set_replica(oid, self.region,
                           float("inf") if self._pinned else self.expire,
                           self.size)

    def unbind_index(self) -> None:
        """Detach (replica dropped): cancel the schedule + routing cell."""
        if self._index is not None:
            self._index.disarm(self._ident)
        self._index = None
        if self._routing is not None:
            self._routing.drop_replica(self._oid, self.region)
            self._routing = None

    def _reindex(self) -> None:
        exp = float("inf") if self._pinned else self.expire
        if self._index is not None:
            self._index.arm(self._ident, self._order, exp)
        if self._routing is not None:
            self._routing.set_replica(self._oid, self.region, exp, self.size)

    # -- expiry-moving fields (mutations re-index) ---------------------------
    @property
    def last_access(self) -> float:
        return self._last_access

    @last_access.setter
    def last_access(self, value: float) -> None:
        self._last_access = value
        self._reindex()

    @property
    def ttl(self) -> float:
        return self._ttl

    @ttl.setter
    def ttl(self, value: float) -> None:
        self._ttl = value
        self._reindex()

    @property
    def pinned(self) -> bool:
        return self._pinned

    @pinned.setter
    def pinned(self, value: bool) -> None:
        self._pinned = value
        self._reindex()

    def touch(self, now: float, ttl: Optional[float] = None) -> None:
        """Access-time update: set ``last_access`` (and optionally ``ttl``)
        with ONE re-index instead of the two the property setters would
        perform back to back -- the GET hot path's TTL re-arm."""
        self._last_access = now
        if ttl is not None:
            self._ttl = ttl
        self._reindex()

    @property
    def expire(self) -> float:
        return self._last_access + self._ttl

    def __repr__(self) -> str:
        return (f"ReplicaMeta(region={self.region!r}, status={self.status!r}, "
                f"created_at={self.created_at!r}, "
                f"last_access={self._last_access!r}, ttl={self._ttl!r}, "
                f"pinned={self._pinned!r}, etag={self.etag!r}, "
                f"size={self.size!r})")

    def to_json(self) -> dict:
        return {
            "region": self.region,
            "status": self.status,
            "created_at": self.created_at,
            "last_access": self._last_access,
            "ttl": None if math.isinf(self._ttl) else self._ttl,
            "pinned": self._pinned,
            "etag": self.etag,
            "size": self.size,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ReplicaMeta":
        d = dict(d)
        d["ttl"] = float("inf") if d["ttl"] is None else d["ttl"]
        return cls(**d)


@dataclasses.dataclass
class VersionMeta:
    version: int
    size: int
    etag: str
    last_modified: float
    replicas: Dict[str, ReplicaMeta]


@dataclasses.dataclass
class ObjectMeta:
    bucket: str
    key: str
    base_region: Optional[str]
    versions: List[VersionMeta]

    @property
    def latest(self) -> Optional[VersionMeta]:
        return self.versions[-1] if self.versions else None


class MetadataServer:
    """Stateless-service semantics over an in-process table (the paper backs
    this with Postgres; the table layout is the same)."""

    def __init__(
        self,
        cost: CostModel,
        mode: str = "FB",
        controller: Optional[AdaptiveTTLController] = None,
        pending_timeout: float = 300.0,
        versioning: bool = True,
        ledger: Optional[CostLedger] = None,
        min_fp_copies: int = 1,
        oracle=None,
        clock=None,
        routing: str = "auto",
        latency_weight: float = 0.0,
        device="cuda",
    ) -> None:
        self.cost = cost
        self.mode = mode
        #: §6.3 latency-vs-egress routing knob: GET source selection scores
        #: holders by ``egress_price + latency_weight * get_latency_ms``.
        #: Zero keeps the original price-only decision stream bit-identical.
        self.latency_weight = float(latency_weight)
        #: Injected time source for callers that omit ``now=`` (the
        #: VirtualStore boundary installs its own clock here).  The metadata
        #: server itself never reads the host clock: with no injected clock
        #: an omitted ``now`` resolves to the virtual-time origin 0.0, so a
        #: bare server stays deterministic (replaylint RS001).
        self.clock = clock
        #: Checked even when a ``controller`` is given (which keeps the
        #: device it was built on); with none, the server builds its own here.
        self.device = resolve_device(device)
        self.ctl = controller or AdaptiveTTLController(cost, device=self.device)
        self.pending_timeout = pending_timeout
        self.versioning = versioning
        #: Optional future-knowledge attachment point (§3.1.1): trace replay
        #: parks the shared :class:`~repro_torch.core.oracle.TraceOracle` here (the
        #: VirtualStore forwards its own), so clairvoyant policies and
        #: control-plane tooling read one oracle instance per replay.
        self.oracle = oracle
        #: FP-mode safety floor: the eviction scan never drops below this
        #: many committed copies (same knob as Simulator.min_fp_copies).
        self.min_fp_copies = min_fp_copies
        #: Optional live-plane cost accounting (see repro_torch.core.ledger): replica
        #: lifetime open/close events are reported from the mutation sites.
        self.ledger = ledger
        #: The shared §3.2 lazy expiration heap (same class as the
        #: Simulator's): every committed replica with a finite TTL is armed
        #: here, so the eviction scan is O(expired) pops, not O(objects).
        self.expiry = ExpiryIndex()
        #: Dense object ids for arbitrary keys -- the cross-plane expiry
        #: sort key and the id policies key their state by (numeric trace
        #: keys keep their integer value, matching the Simulator).
        self.interner = KeyInterner()
        #: Array mirror of the committed-replica table for vectorized GET
        #: routing (repro_torch.core.routing) -- rows keyed by interned oid, kept
        #: in sync through the ReplicaMeta binding hooks.  Built only in
        #: last-writer-wins mode: with versioning there is no single "the
        #: object's replicas" row to mirror, and the batch consumers (trace
        #: replay) always run LWW.
        self._routing_engine = resolve_routing_engine(routing)
        self.routing = (RoutingMatrix(cost, latency_weight=latency_weight)
                        if not versioning and self._routing_engine == "matrix"
                        else None)
        #: §6.4 failure plane: regions currently inside an outage window.
        #: The VirtualStore shares this exact set object (region_down /
        #: region_up mutate it), so GET routing, the eviction guards, and
        #: the data plane's gating all see one consistent view.
        self.unavailable: set = set()
        self.objects: Dict[Tuple[str, str], ObjectMeta] = {}
        self.buckets: Dict[str, dict] = {}
        #: per-bucket sorted key index -- keeps paginated listings O(page)
        #: instead of re-sorting the whole object table per page
        self._key_index: Dict[str, List[str]] = {}
        self._last_get: Dict[Tuple[str, str, str], float] = {}
        self._pending: Dict[Tuple[str, str, str, int], float] = {}
        self.op_log: List[dict] = []

    def _now(self, now: Optional[float]) -> float:
        """Resolve an optional event time: explicit ``now`` wins, then the
        injected clock, then the virtual-time origin."""
        if now is not None:
            return now
        return self.clock() if self.clock is not None else 0.0

    # -- buckets ---------------------------------------------------------------
    def create_bucket(self, bucket: str, now: Optional[float] = None,
                      **attrs) -> None:
        self.buckets.setdefault(bucket, dict(created=self._now(now), **attrs))
        self._key_index.setdefault(bucket, [])

    def list_buckets(self) -> List[str]:
        return sorted(self.buckets)

    def delete_bucket(self, bucket: str) -> None:
        if bucket not in self.buckets:
            raise ApiError("NoSuchBucket", f"no such bucket {bucket!r}")
        if self._key_index.get(bucket):
            raise ApiError("BucketNotEmpty", f"bucket {bucket!r} not empty")
        del self.buckets[bucket]
        self._key_index.pop(bucket, None)

    def _bind_replica(self, bucket: str, key: str, version: int,
                      rm: ReplicaMeta) -> None:
        """Register one replica with the shared expiry index.  The identity
        is (bucket, key, version, region); the *sort* key is (oid, region)
        -- the exact ordering the simulator's heap uses -- so both planes
        pop coincident expirations identically."""
        oid = self.interner.intern(key)
        rm.bind_index(self.expiry, (bucket, key, version, rm.region),
                      (oid, rm.region))
        if self.routing is not None and rm.status == COMMITTED:
            rm.bind_routing(self.routing, oid)

    def _index_add(self, bucket: str, key: str) -> None:
        keys = self._key_index.setdefault(bucket, [])
        i = bisect.bisect_left(keys, key)
        if i == len(keys) or keys[i] != key:
            keys.insert(i, key)

    def _index_remove(self, bucket: str, key: str) -> None:
        keys = self._key_index.get(bucket)
        if keys is None:
            return
        i = bisect.bisect_left(keys, key)
        if i < len(keys) and keys[i] == key:
            keys.pop(i)

    # -- 2PC writes ---------------------------------------------------------------
    def begin_upload(
        self, bucket: str, key: str, region: str, size: int, now: Optional[float] = None
    ) -> int:
        """Phase 1: log the intent; returns the version this upload will commit."""
        now = self._now(now)
        if bucket not in self.buckets:
            raise ApiError("NoSuchBucket", f"no such bucket {bucket!r}")
        om = self.objects.get((bucket, key))
        if om is None:
            om = ObjectMeta(bucket, key, None, [])
            self.objects[(bucket, key)] = om
            self._index_add(bucket, key)
        version = (om.latest.version + 1) if om.latest else 1
        self._pending[(bucket, key, region, version)] = now
        self.op_log.append(
            dict(op="begin_upload", bucket=bucket, key=key, region=region,
                 version=version, t=now)
        )
        return version

    def complete_upload(
        self, bucket: str, key: str, region: str, version: int, size: int,
        etag: str, now: Optional[float] = None,
    ) -> VersionMeta:
        """Phase 2: commit -- only now does the object become visible (§4.5)."""
        now = self._now(now)
        if (bucket, key, region, version) not in self._pending:
            raise ApiError("NoSuchUpload",
                           "complete_upload without matching begin_upload")
        del self._pending[(bucket, key, region, version)]
        om = self.objects[(bucket, key)]
        placement = resolve_put_placement(self.mode, om.base_region, region)
        om.base_region = placement.base_region   # write-local fixes the FB base
        vm = next((v for v in om.versions if v.version == version), None)
        if vm is None:
            vm = VersionMeta(version, size, etag, now, {})
            om.versions.append(vm)
            om.versions.sort(key=lambda v: v.version)
            if not self.versioning and len(om.versions) > 1:
                # Last-writer-wins: stale versions' replicas end here (§4.4).
                for old_vm in om.versions[:-1]:
                    for r, old_rm in old_vm.replicas.items():
                        old_rm.unbind_index()
                        if self.ledger is not None:
                            self.ledger.on_replica_drop(
                                bucket, key, r, now, version=old_vm.version)
                om.versions = om.versions[-1:]
        pinned = placement.pinned
        replaced = vm.replicas.get(region)
        if replaced is not None:
            replaced.unbind_index()
        rm = ReplicaMeta(
            region, COMMITTED, now, now, float("inf"), pinned, etag, size
        )
        vm.replicas[region] = rm
        self._bind_replica(bucket, key, version, rm)
        self._rearm_unscheduled(bucket, key, vm)
        if self.ledger is not None:
            self.ledger.on_replica_commit(bucket, key, region, size, pinned,
                                          now, version=version)
        self.op_log.append(
            dict(op="complete_upload", bucket=bucket, key=key, region=region,
                 version=version, t=now)
        )
        return vm

    def abort_upload(self, bucket: str, key: str, region: str, version: int) -> None:
        self._pending.pop((bucket, key, region, version), None)
        self.op_log.append(dict(op="abort_upload", bucket=bucket, key=key,
                                region=region, version=version))

    def expire_pending(self, now: Optional[float] = None) -> List[Tuple]:
        """Roll back uploads whose proxy died mid-write (§4.5 timeout)."""
        now = self._now(now)
        stale = [k for k, t0 in self._pending.items()
                 if now - t0 > self.pending_timeout]
        for k in stale:
            del self._pending[k]
        return stale

    # -- reads ----------------------------------------------------------------------
    def locate(
        self, bucket: str, key: str, region: str, now: Optional[float] = None,
        version: Optional[int] = None,
    ) -> Tuple[VersionMeta, str, bool]:
        """Route a GET: returns (version, source region, was_local_hit) --
        cheapest committed replica per §2.3, directed at the latest version."""
        now = self._now(now)
        om = self.objects.get((bucket, key))
        if om is None or not om.versions:
            raise ApiError("NoSuchKey", f"{bucket}/{key} not found")
        if version is None:
            vm = om.latest
        else:
            vm = next((v for v in om.versions if v.version == version), None)
            if vm is None:
                raise ApiError("NoSuchVersion",
                               f"{bucket}/{key} has no version {version}")
        committed = self._holders_of(vm)
        if not committed:
            raise ApiError("NoSuchKey", f"{bucket}/{key} has no committed replica")
        src, hit = choose_get_source(committed, region, now, self.cost,
                                     self.unavailable, float(vm.size),
                                     self.latency_weight)
        return vm, src, hit

    @staticmethod
    def _holders_of(vm: VersionMeta) -> Dict[str, float]:
        return {
            r: (float("inf") if m.pinned else m.expire)
            for r, m in vm.replicas.items() if m.status == COMMITTED
        }

    def holders(self, bucket: str, key: str) -> Dict[str, float]:
        """{region: expiry} over committed replicas of the latest version
        (``inf`` for pinned) -- the map both §2.3 GET routing and policy
        ``ttl_on_access`` consume; identical to ``Simulator.holders``."""
        om = self.objects.get((bucket, key))
        if om is None or om.latest is None:
            return {}
        return self._holders_of(om.latest)

    def record_get(
        self, bucket: str, key: str, region: str, size: int, hit: bool,
        now: Optional[float] = None,
    ) -> None:
        now = self._now(now)
        gk = (bucket, key, region)
        prev = self._last_get.get(gk)
        if prev is not None:
            self.ctl.record_gap(bucket, region, now - prev, size)
        else:
            self.ctl.record_first_read(bucket, region, size, remote=not hit)
        self._last_get[gk] = now

    def commit_replica(
        self, bucket: str, key: str, region: str, size: int, etag: str,
        now: Optional[float] = None, ttl: Optional[float] = None,
    ) -> ReplicaMeta:
        """Register a replicate-on-read copy with its adaptive TTL (§3.3.1).
        An explicit ``ttl`` overrides the built-in controller -- that is how a
        pluggable :class:`~repro_torch.core.policies.Policy` drives the live plane
        (see ``VirtualStore(policy=...)``)."""
        now = self._now(now)
        om = self.objects[(bucket, key)]
        vm = om.latest
        if ttl is None:
            ttl = self._object_ttl(bucket, region, self._holders_of(vm), now)
        pinned = resolve_put_placement(self.mode, om.base_region, region).pinned
        replaced = vm.replicas.get(region)
        if replaced is not None:
            replaced.unbind_index()
        rm = ReplicaMeta(region, COMMITTED, now, now, ttl, pinned, etag, size)
        vm.replicas[region] = rm
        self._bind_replica(bucket, key, vm.version, rm)
        self._rearm_unscheduled(bucket, key, vm)
        if self.ledger is not None:
            self.ledger.on_replica_commit(bucket, key, region, size, pinned,
                                          now, version=vm.version)
        return rm

    def touch_replica(self, bucket: str, key: str, region: str,
                      now: Optional[float] = None,
                      ttl: Optional[float] = None) -> None:
        """TTL reset on access (§3.2.1); explicit ``ttl`` = policy override."""
        now = self._now(now)
        om = self.objects[(bucket, key)]
        vm = om.latest
        rm = vm.replicas.get(region)
        if rm is None:
            return
        if ttl is None and not rm.pinned:
            ttl = self._object_ttl(bucket, region, self._holders_of(vm), now)
        rm.touch(now, ttl if (not rm.pinned and ttl is not None) else None)

    def drop_replica(self, bucket: str, key: str, region: str,
                     now: Optional[float] = None,
                     count_eviction: bool = False) -> Optional[int]:
        """Forget one replica (policy-driven eviction, read-repair).  Returns
        the version whose physical blob the caller should DELETE, or None."""
        now = self._now(now)
        om = self.objects.get((bucket, key))
        vm = om.latest if om is not None else None
        rm = vm.replicas.pop(region, None) if vm is not None else None
        if rm is None:
            return None
        rm.unbind_index()
        if self.ledger is not None:
            self.ledger.on_replica_drop(bucket, key, region, now,
                                        count_eviction=count_eviction,
                                        version=vm.version)
        return vm.version

    def _object_ttl(self, bucket: str, region: str, holders: Dict[str, float],
                    now: float) -> float:
        edge = {
            s: self.ctl.edge_ttl(bucket, s, region, now)
            for s in holders if s != region
        }
        if not edge:
            return float("inf")
        safe = {s: t for s, t in edge.items() if holders.get(s, 0) >= now + t}
        pool = safe or {s: t for s, t in edge.items() if math.isinf(holders.get(s, 0))} or edge
        return float(min(pool.values()))

    # -- eviction scan (§4.2 background process) -----------------------------------
    def scan_expired(self, now: Optional[float] = None) -> List[Tuple[str, str, str, int]]:
        """Return (bucket, key, region, version) of replicas to DELETE.  The
        caller (proxy / lifecycle worker) performs the physical deletes; we
        only mutate metadata -- "no data transfer occurs" (§4.2).

        O(expired): due replicas pop off the shared
        :class:`~repro_torch.core.expiry.ExpiryIndex` in the *same*
        (expire, oid, region) order the simulator's heap uses -- so the
        survivor under the sole-copy guard is identical in both planes by
        construction, not by careful mirroring.  In FP mode the sole
        surviving copy is never evicted: its expiry is re-armed instead
        (§3.2.1); a re-arm still below ``now`` pops again within this scan.
        """
        now = self._now(now)
        out = []
        for texp, ident in self.expiry.pop_due(now):
            victim = self.expire_replica(ident, texp)
            if victim is not None:
                out.append(victim)
        return out

    def expire_batch(
        self, pops: List[Tuple[float, Tuple]]
    ) -> List[Tuple[str, str, str, int]]:
        """Process one drain round off ``self.expiry`` (the batched spine's
        EXPIRE handler).  Guards and metadata mutation run per entry in pop
        order -- later guards must see earlier drops -- but the round's
        ledger charges are applied in one vectorized
        :meth:`CostLedger.on_replica_drop_batch` call.  Returns the
        (bucket, key, region, version) victims to physically DELETE, in pop
        order."""
        drops: List[Tuple[str, str, str, float, int]] = []
        victims: List[Tuple[str, str, str, int]] = []
        for texp, ident in pops:
            victim = self.expire_replica(ident, texp, _drops=drops)
            if victim is not None:
                victims.append(victim)
        if self.ledger is not None and drops:
            self.ledger.on_replica_drop_batch(drops)
        return victims

    def expire_replica(
        self, ident, texp: float, _drops: Optional[List] = None,
    ) -> Optional[Tuple[str, str, str, int]]:
        """Process ONE expiry already popped off ``self.expiry`` (by
        :meth:`scan_expired` or by the event spine's EXPIRE handler).
        Returns the (bucket, key, region, version) to physically DELETE, or
        None if the pop was stale / guarded (pinned, sole FP copy).

        ``_drops`` is the :meth:`expire_batch` charge-deferral hook: when
        given, a drop appends ``(bucket, key, region, end, version)`` there
        instead of charging the ledger immediately."""
        bucket, key, version, region = ident
        om = self.objects.get((bucket, key))
        vm = None
        if om is not None:
            vm = next((v for v in om.versions if v.version == version), None)
        m = vm.replicas.get(region) if vm is not None else None
        if m is None or m.status != COMMITTED or m.pinned:
            return None
        if m.expire > texp:
            # Out-of-band mutation moved the expiry without the property
            # setters seeing it; restore the schedule rather than dropping.
            self._bind_replica(bucket, key, version, m)
            return None
        if region in self.unavailable:
            # §6.4: the region is dark -- the physical delete cannot run.
            # Step the expiry (property setter re-arms) so a pop after
            # recovery collects it; same rule as Simulator._expire_one.
            m.last_access += max(m.ttl, 3600.0)
            return None
        alive = sum(1 for x in vm.replicas.values() if x.status == COMMITTED)
        if alive > self.min_fp_copies:
            if self.unavailable and not any(
                    r for r, x in vm.replicas.items()
                    if (r != region and x.status == COMMITTED
                        and r not in self.unavailable)):
                # §6.4 reachable-copy guard: every committed sibling sits in
                # a downed region; dropping this one would 503 the object
                # for the rest of the outage.  Step-and-re-arm instead
                # (identical to Simulator._expire_one's guard).
                m.last_access += max(m.ttl, 3600.0)
                return None
            del vm.replicas[region]
            m.unbind_index()
            if _drops is not None:
                _drops.append((bucket, key, region, m.expire, vm.version))
            elif self.ledger is not None:
                self.ledger.on_replica_drop(bucket, key, region, m.expire,
                                            count_eviction=True,
                                            version=vm.version)
            return (bucket, key, region, vm.version)
        if self.mode == "FP":
            # Sole copy: step the expiry by max(ttl, 1h) (keep paying
            # storage, §3.2.1).  The property setter re-arms; if still due,
            # the surrounding drain pops it again -- the lazy-heap form of
            # the old "re-arm until the expiry clears now" loop.
            m.last_access += max(m.ttl, 3600.0)
        # Non-FP guarded pop (e.g. an unpinned FB sole copy after the base
        # was lost to read-repair): the replica stays, unscheduled, until a
        # sibling commit lifts the guard -- see _rearm_unscheduled.
        return None

    def _rearm_unscheduled(self, bucket: str, key: str, vm: VersionMeta) -> None:
        """A new commit can lift the sole-copy guard off an expired sibling
        whose pop was already consumed (the guarded branch of
        :meth:`expire_replica`).  Put any such replica back on the schedule
        so the next drain collects it -- the legacy full sweep re-examined
        every replica each pass and would have dropped it then."""
        for rm in vm.replicas.values():
            if (rm.status == COMMITTED and not rm.pinned
                    and math.isfinite(rm.expire)
                    and self.expiry.armed_expire(
                        (bucket, key, vm.version, rm.region)) is None):
                self._bind_replica(bucket, key, vm.version, rm)

    def delete_object(self, bucket: str, key: str,
                      now: Optional[float] = None) -> List[Tuple[str, int]]:
        now = self._now(now)
        om = self.objects.pop((bucket, key), None)
        if om is None:
            return []
        self._index_remove(bucket, key)
        for vm in om.versions:
            for m in vm.replicas.values():
                m.unbind_index()
                if self.ledger is not None:
                    self.ledger.on_replica_drop(bucket, key, m.region, now,
                                                version=vm.version)
        return [
            (m.region, vm.version)
            for vm in om.versions
            for m in vm.replicas.values()
        ]

    def list_objects(self, bucket: str, prefix: str = "") -> List[ObjectMeta]:
        """Objects of ``bucket`` under ``prefix``, in key order, straight off
        the per-bucket sorted index (O(log N + matches), not O(N log N))."""
        keys = self._key_index.get(bucket)
        if keys is None:
            return []
        i = bisect.bisect_left(keys, prefix)
        out: List[ObjectMeta] = []
        while i < len(keys) and keys[i].startswith(prefix):
            out.append(self.objects[(bucket, keys[i])])
            i += 1
        return out

    def head_object(self, bucket: str, key: str) -> ObjectMeta:
        om = self.objects.get((bucket, key))
        if om is None:
            raise ApiError("NoSuchKey", f"{bucket}/{key} not found")
        return om

    # -- fault tolerance (§4.5) ------------------------------------------------------
    def backup(self) -> bytes:
        doc = {
            "buckets": self.buckets,
            "objects": [
                {
                    "bucket": om.bucket,
                    "key": om.key,
                    "base_region": om.base_region,
                    "versions": [
                        {
                            "version": vm.version,
                            "size": vm.size,
                            "etag": vm.etag,
                            "last_modified": vm.last_modified,
                            "replicas": {r: m.to_json() for r, m in vm.replicas.items()},
                        }
                        for vm in om.versions
                    ],
                }
                for om in self.objects.values()
            ],
        }
        return json.dumps(doc).encode()

    @classmethod
    def restore(cls, blob: bytes, cost: CostModel, mode: str = "FB",
                device="cuda") -> "MetadataServer":
        doc = json.loads(blob.decode())
        ms = cls(cost, mode=mode, device=device)
        ms.buckets = dict(doc["buckets"])
        for o in doc["objects"]:
            om = ObjectMeta(o["bucket"], o["key"], o["base_region"], [])
            for v in o["versions"]:
                om.versions.append(
                    VersionMeta(
                        v["version"], v["size"], v["etag"], v["last_modified"],
                        {r: ReplicaMeta.from_json(m) for r, m in v["replicas"].items()},
                    )
                )
            ms.objects[(om.bucket, om.key)] = om
        for bucket in ms.buckets:
            ms._key_index.setdefault(bucket, [])
        for (bucket, key), om in ms.objects.items():
            ms._index_add(bucket, key)
            for vm in om.versions:
                for rm in vm.replicas.values():
                    ms._bind_replica(bucket, key, vm.version, rm)
        return ms

    def reconcile(self, backends: Dict[str, "object"]) -> int:
        """Rebuild metadata for objects found in physical stores but missing
        from the table (recovery from an incomplete backup, §4.5)."""
        found = 0
        for region, be in backends.items():
            for bucket in self.buckets:
                for h in be.list(bucket):
                    if h.key.startswith("__skystore_"):
                        continue        # internal blobs (meta backups, MPU parts)
                    om = self.objects.get((bucket, h.key))
                    if om is None:
                        om = ObjectMeta(bucket, h.key, region, [])
                        self.objects[(bucket, h.key)] = om
                        self._index_add(bucket, h.key)
                    if not om.versions:
                        om.versions.append(
                            VersionMeta(1, h.size, h.etag, h.last_modified, {})
                        )
                    vm = om.latest
                    if region not in vm.replicas:
                        rm = ReplicaMeta(
                            region, COMMITTED, h.last_modified, h.last_modified,
                            float("inf"), region == om.base_region, h.etag, h.size,
                        )
                        vm.replicas[region] = rm
                        self._bind_replica(bucket, h.key, vm.version, rm)
                        found += 1
        return found
