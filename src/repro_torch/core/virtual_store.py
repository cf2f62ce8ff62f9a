"""The client-facing virtual object store (paper §4.1 + §4.3).

:class:`VirtualStore` implements :class:`~repro_torch.core.api.ObjectStoreAPI` --
the unified typed op layer -- for live serving.  It exposes virtual
buckets/objects that "appear global to the user", consults the metadata server
for routing, moves the actual bytes between physical backends, and implements
the paper's placement policy mechanics:

  * PUT  -> write-local + 2PC commit (§2.3, §4.5);
  * GET  -> cheapest committed replica; on a remote read, replicate-on-read
    with the adaptive TTL (§2.3, §3); ranged and conditional variants serve
    from the same path;
  * DELETE / HEAD / LIST / COPY / multipart upload -- the full S3 surface the
    paper supports, minus auth plumbing.

Every op arrives as a typed request object through :meth:`dispatch`; the
legacy keyword methods (``put_object`` et al.) are thin wrappers kept for
existing callers (training framework, benchmarks, examples).

Multipart uploads spill their parts into the local-region *backend* under
``__skystore_mpu__/`` instead of buffering them in proxy RAM, so an upload's
working set is bounded by one part, not the whole object.

This is the layer the training framework mounts: checkpoints and data shards
are virtual objects, so multi-region fault tolerance falls out of the paper's
own machinery.

This is the PyTorch port's copy of :mod:`repro.core.virtual_store`.  Bytes,
ETags and charges stay on the host; ``device`` is where the metadata
server's TTL controller runs its kernel when the store builds that server
("cuda" by default; a missing or pre-Hopper card raises).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Iterable, List, Optional, Tuple

from .api import (
    Ack,
    AbortMultipartRequest,
    ApiError,
    CompleteMultipartRequest,
    CompleteMultipartResponse,
    CopyRequest,
    CopyResponse,
    CreateBucketRequest,
    CreateMultipartRequest,
    CreateMultipartResponse,
    DeleteBucketRequest,
    DeleteObjectRequest,
    DeleteObjectsRequest,
    DeleteObjectsResponse,
    GetRequest,
    GetResponse,
    HeadRequest,
    HeadResponse,
    ListBucketsRequest,
    ListBucketsResponse,
    ListRequest,
    ListResponse,
    ObjectSummary,
    PutRequest,
    PutResponse,
    Request,
    UploadPartRequest,
    UploadPartResponse,
    check_preconditions,
    decode_continuation_token,
    encode_continuation_token,
    resolve_put_region,
    resolve_range,
)
from ..kernels.ops import resolve_device
from .backends import Backend, HeadResult
from .costmodel import CostModel
from .ledger import CostLedger
from .metadata import COMMITTED, MetadataServer
from .policies import GetContext, Policy
from .routing import ROUTE_OK

#: Key prefix for internal blobs (multipart spill space, metadata backups).
MPU_PREFIX = "__skystore_mpu__/"

#: Hard cap ListObjectsV2 shares with S3.
MAX_LIST_KEYS = 1000


@dataclasses.dataclass
class TransferLog:
    """Egress accounting for real (non-simulated) usage."""

    bytes_moved: Dict[Tuple[str, str], int] = dataclasses.field(default_factory=dict)
    dollars: float = 0.0

    def add(self, cost: CostModel, src: str, dst: str, nbytes: int) -> None:
        if src == dst:
            return
        self.bytes_moved[(src, dst)] = self.bytes_moved.get((src, dst), 0) + nbytes
        self.dollars += cost.transfer_cost(src, dst, nbytes)


@dataclasses.dataclass
class _MultipartUpload:
    bucket: str
    key: str
    region: str
    parts: Dict[int, Tuple[str, int]] = dataclasses.field(default_factory=dict)
    # part_number -> (etag, size); bytes live in the region backend, not here


class VirtualStore:
    """Implements :class:`~repro_torch.core.api.ObjectStoreAPI` over physical
    backends + the metadata control plane."""

    #: Working-set bound for streaming multipart completion: parts are read
    #: back and re-written in chunks of at most this many bytes.
    mpu_chunk_size = 8 * 1024 * 1024

    def __init__(
        self,
        cost: CostModel,
        backends: Dict[str, Backend],
        meta: Optional[MetadataServer] = None,
        mode: str = "FB",
        clock=None,
        policy: Optional[Policy] = None,
        ledger: Optional[CostLedger] = None,
        min_fp_copies: int = 1,
        oracle=None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        missing = set(cost.region_names()) - set(backends)
        if missing:
            raise ValueError(f"backends missing for regions {sorted(missing)}")
        self.cost = cost
        self.backends = backends
        #: A pluggable placement policy (any Simulator policy).  When set, the
        #: live GET/PUT paths consult it for cache-on-read, TTL, and
        #: replicate-on-write decisions instead of the built-in adaptive-TTL
        #: controller -- the same decision surface the Simulator drives, so a
        #: trace replayed through both planes takes identical placements
        #: (verified by repro_torch.core.replay).
        self.policy = policy
        self.mode = getattr(policy, "mode", None) or mode
        #: Optional live-plane cost accounting (repro_torch.core.ledger).
        self.ledger = ledger
        self.min_fp_copies = min_fp_copies
        # The ONE sanctioned wall-clock default in the storage core: a real
        # deployment needs host time at the serving boundary, while replay
        # always injects a virtual clock.  Everything downstream (metadata
        # server, backends) takes time from here -- never from the host
        # directly (see docs/ARCHITECTURE.md, "Determinism contract").
        self._clock = clock or time.time  # replaylint: disable=RS001
        # Policy mode runs last-writer-wins: the simulator models a single
        # live version, so superseded replicas must drop on overwrite.
        self.meta = meta or MetadataServer(cost, mode=self.mode, ledger=ledger,
                                           versioning=policy is None,
                                           min_fp_copies=min_fp_copies,
                                           clock=self._clock,
                                           device=self.device)
        if self.meta.clock is None:
            self.meta.clock = self._clock
        for be in backends.values():
            if be.clock is None:
                be.clock = self._clock
        #: Future knowledge for clairvoyant policies (§3.1.1): a
        #: :class:`~repro_torch.core.oracle.TraceOracle` (or anything implementing
        #: :class:`~repro_torch.core.policies.Oracle`).  Shared with the metadata
        #: server so both halves of the live plane consult one instance.
        self.oracle = oracle if oracle is not None else getattr(
            self.meta, "oracle", None)
        if self.oracle is not None:
            if self.meta.oracle is None:
                self.meta.oracle = self.oracle
            if policy is not None and policy.oracle is None:
                policy.oracle = self.oracle
        if policy is not None and policy.requires_oracle and policy.oracle is None:
            raise ValueError(
                f"policy {policy.name!r} is clairvoyant (requires_oracle=True) "
                "but no oracle is attached: pass VirtualStore(..., "
                "oracle=TraceOracle.from_trace(trace, epoch_len=policy.epoch)) "
                "(see repro_torch.core.oracle) or assign policy.oracle before "
                "constructing the store")
        if (policy is not None and policy.epoch is not None
                and getattr(policy.oracle, "epoch_len", None) != policy.epoch):
            # An epoch solver without matching epoch summaries would either
            # crash at the first boundary (no oracle at all) or silently
            # place from a zero workload -- refuse at construction time,
            # whatever the policy's requires_oracle flag says.
            raise ValueError(
                f"policy {policy.name!r} re-solves every {policy.epoch:g}s "
                "but its oracle "
                f"{'is missing' if policy.oracle is None else 'was built with epoch_len=' + repr(getattr(policy.oracle, 'epoch_len', None))}"
                ": construct it as TraceOracle.from_trace(trace, "
                "epoch_len=policy.epoch) so epoch_summary() serves the "
                "solver real workloads")
        if policy is not None:
            # The hit-path guards here and the scan-time guards in the
            # metadata server must see one consistent configuration.
            if self.meta.versioning:
                raise ValueError("policy-driven VirtualStore requires a "
                                 "MetadataServer(versioning=False) (LWW)")
            if self.meta.mode != self.mode:
                raise ValueError(f"MetadataServer mode {self.meta.mode!r} != "
                                 f"effective store mode {self.mode!r}")
            if self.meta.min_fp_copies != self.min_fp_copies:
                raise ValueError("MetadataServer.min_fp_copies "
                                 f"{self.meta.min_fp_copies} != store's "
                                 f"{self.min_fp_copies}")
        if ledger is not None and self.meta.ledger is None:
            self.meta.ledger = ledger
        # §6.3: the policy's latency-vs-egress routing knob must reach the
        # control plane's GET routing (scalar locate AND the routing
        # matrix), whether the MetadataServer was built here or injected.
        lw = float(getattr(policy, "latency_weight", 0.0)) if policy else 0.0
        if lw and self.meta.latency_weight != lw:
            self.meta.latency_weight = lw
            if self.meta.routing is not None:
                self.meta.routing.latency_weight = lw
        self.transfers = TransferLog()
        #: §6.4 failure plane: regions currently down.  This is the *same
        #: set object* the metadata server consults for GET routing and the
        #: eviction guards -- region_down/region_up mutate it in place.
        self.unavailable = self.meta.unavailable
        #: §4.4 syncs deferred past a base-region outage:
        #: (bucket, key) -> write-local landing region; drained at region_up.
        self._pending_sync: Dict[Tuple[str, str], str] = {}
        self._mpu: Dict[str, _MultipartUpload] = {}
        # policy-mode bookkeeping, mirroring Simulator._last_get/_open_last
        self._last_get: Dict[Tuple[str, str, str], float] = {}
        self._open_last: Dict[Tuple[str, str], Dict[object, Tuple[float, float]]] = {}

    # -- the unified op entry point ------------------------------------------
    def dispatch(self, op: Request):
        handler = self._HANDLERS.get(type(op))
        if handler is None:
            raise ApiError("InvalidRequest", f"unsupported op {type(op).__name__}")
        return getattr(self, handler)(op)

    def _now(self, op) -> float:
        return op.at if op.at is not None else self._clock()

    # -- bucket ops -----------------------------------------------------------
    def _handle_create_bucket(self, op: CreateBucketRequest) -> Ack:
        self.meta.create_bucket(op.bucket, now=self._now(op))
        return Ack()

    def _handle_delete_bucket(self, op: DeleteBucketRequest) -> Ack:
        self.meta.delete_bucket(op.bucket)
        # reclaim any in-flight multipart spill space in this bucket
        for uid in [u for u, m in self._mpu.items() if m.bucket == op.bucket]:
            self._discard_mpu(uid)
        return Ack()

    def _handle_list_buckets(self, op: ListBucketsRequest) -> ListBucketsResponse:
        return ListBucketsResponse(self.meta.list_buckets())

    # -- object ops -----------------------------------------------------------
    def _put_landing_region(self, bucket: str, key: str, region: str) -> str:
        """§6.4: the effective write-local region -- the issuing region
        unless it is down, then the live base, then the cheapest live
        region; 503 on a full blackout (same rule as the simulator)."""
        om = self.meta.objects.get((bucket, key))
        base = om.base_region if (om is not None and self.mode == "FB") else None
        return resolve_put_region(region, base, self.unavailable, self.cost)

    def _handle_put(self, op: PutRequest) -> PutResponse:
        """Write-local PUT with the two-phase commit of §4.5."""
        if op.body is None:
            raise ApiError("InvalidRequest", "PUT outside simulation needs a body")
        now = self._now(op)
        data = op.body
        if self.policy is not None:
            return self._policy_put(op, data, now)
        region = self._put_landing_region(op.bucket, op.key, op.region)
        if self.ledger is not None:
            self.ledger.count_put()
            self.ledger.charge_op(region, "PUT")
            self.ledger.record_put_latency(op.region, region, float(len(data)))
        version = self.meta.begin_upload(op.bucket, op.key, region,
                                         len(data), now)
        h = self.backends[region].put(op.bucket,
                                      self._pkey(op.key, version), data)
        self.meta.complete_upload(op.bucket, op.key, region, version,
                                  len(data), h.etag, now)
        return PutResponse(version, h.etag)

    def _policy_put(self, op: PutRequest, data: bytes, now: float) -> PutResponse:
        """Mirror of ``Simulator._handle_put``: write-local commit (§6.4
        outage redirect included), §4.4 sync-to-base on cross-region
        overwrite (with a policy TTL on the write-local cache copy), then
        policy-chosen replication targets.

        Policy mode runs the metadata server in last-writer-wins mode
        (``versioning=False``) so stale versions drop on overwrite exactly as
        in the simulator; their physical blobs are deleted here.
        """
        size = len(data)
        # Raises ServiceUnavailable (uncharged) on a full blackout -- the
        # same pre-charge ordering as Simulator._handle_put.
        region = self._put_landing_region(op.bucket, op.key, op.region)
        self._pending_sync.pop((op.bucket, op.key), None)  # overwrite re-decides
        if self.ledger is not None:
            self.ledger.count_put()
            self.ledger.charge_op(region, "PUT")
        stale = self._stale_blobs(op.bucket, op.key)
        version = self.meta.begin_upload(op.bucket, op.key, region, size, now)
        pkey = self._pkey(op.key, version)
        h = self.backends[region].put(op.bucket, pkey, data)
        self.meta.complete_upload(op.bucket, op.key, region, version,
                                  size, h.etag, now)
        self._policy_put_mechanics(
            op.bucket, op.key, region, size, h.etag, version, stale, now,
            write_to=lambda dst: self.backends[dst].put(op.bucket, pkey, data),
        )
        if self.ledger is not None:
            # §6.3: origin -> effective landing region, the same value the
            # simulator appends at the end of its _handle_put.
            self.ledger.record_put_latency(op.region, region, float(size))
        return PutResponse(version, h.etag)

    def _stale_blobs(self, bucket: str, key: str) -> List[Tuple[str, int]]:
        """Physical blobs of the version a policy-mode PUT is about to
        supersede (LWW)."""
        om = self.meta.objects.get((bucket, key))
        if om is None or om.latest is None:
            return []
        return [(r, om.latest.version) for r in om.latest.replicas]

    def _policy_put_mechanics(
        self, bucket: str, key: str, region: str, size: int, etag: str,
        version: int, stale: List[Tuple[str, int]], now: float, write_to,
    ) -> None:
        """Post-commit placement mechanics shared by the bytes and streaming
        PUT paths: LWW stale-blob deletes, §4.4 sync-to-base with a policy
        TTL on the write-local copy, then policy replicate-on-write targets.
        ``write_to(dst_region)`` performs the physical replication write."""
        oid = self._obj_id(key)
        for r, v in stale:   # v < version always: begin_upload increments
            self.backends[r].delete(bucket, self._pkey(key, v))
        om = self.meta.objects[(bucket, key)]
        vm = om.latest
        base = om.base_region
        if self.mode == "FB" and region != base:
            if base in self.unavailable:
                # §6.4: the base is dark -- defer the §4.4 sync to
                # region_up.  The landing replica keeps its infinite TTL
                # meanwhile (it may be the newest version's only copy).
                self._pending_sync[(bucket, key)] = region
                if self.ledger is not None:
                    self.ledger.count_deferred_sync()
            else:
                # Sync replication keeps the pinned base fresh (§4.4).
                self.transfers.add(self.cost, region, base, size)
                if self.ledger is not None:
                    self.ledger.charge_transfer(region, base, size)
                    self.ledger.charge_op(base, "PUT")
                    self.ledger.count_replication()
                write_to(base)
                self.meta.commit_replica(bucket, key, base, size, etag,
                                         now, ttl=float("inf"))
                # The write-local copy is a cache replica: policy TTL.
                ctx = GetContext(oid, bucket, region, base, float(size), now,
                                 hit=True, gap=None)
                ttl = self.policy.ttl_on_access(
                    ctx, self.meta.holders(bucket, key))
                if ttl <= 0:
                    self._evict_replica(bucket, key, region, now)
                else:
                    self.meta.touch_replica(bucket, key, region, now, ttl=ttl)
        for target in self.policy.replicate_on_write(oid, bucket, region,
                                                     float(size), now):
            if (target == region or target in vm.replicas
                    or target in self.unavailable):
                continue
            self.transfers.add(self.cost, region, target, size)
            if self.ledger is not None:
                self.ledger.charge_transfer(region, target, size)
                self.ledger.charge_op(target, "PUT")
                self.ledger.count_replication()
            write_to(target)
            self.meta.commit_replica(bucket, key, target, size, etag,
                                     now, ttl=float("inf"))

    def _handle_get(self, op: GetRequest, _hints=None,
                    _k: int = -1) -> GetResponse:
        """Cheapest-source GET + replicate-on-read (§2.3), with ranged and
        conditional variants.

        Read-repair (§4.5): if the chosen replica's physical bytes are gone
        (region outage), the stale replica is dropped from metadata and the
        read retries against the surviving copies.

        ``_hints``/``_k`` are the batched replay driver's vectorized routing
        answers (:class:`~repro_torch.core.routing.RouteHints`, this GET at ordinal
        ``_k``): when the row-version snapshot is still fresh the hint
        replaces :meth:`MetadataServer.locate` outright -- decision-identical
        by the routing module's argmin/tie-break contract -- and its
        precomputed charge vector elements feed the ledger.  Any staleness,
        non-OK status, versioned read, or lost physical bytes falls back to
        the scalar path below, the reference oracle."""
        now = self._now(op)
        body = full = None
        hinted = False
        if _hints is not None and op.version is None:
            row = _hints.rows[_k]
            if (row >= 0 and _hints.live_ver[row] == _hints.vers[_k]
                    and _hints.status[_k] == ROUTE_OK):
                vm = self.meta.objects[(op.bucket, op.key)].latest
                src, hit = _hints.srcs[_k], _hints.hits[_k]
                check_preconditions(vm.etag, op.if_match, op.if_none_match)
                rng = resolve_range(op.range_, vm.size)
                try:
                    if hit and rng is not None:
                        body = self.backends[src].get(
                            op.bucket, self._pkey(op.key, vm.version), rng)
                    else:
                        full = self.backends[src].get(
                            op.bucket, self._pkey(op.key, vm.version))
                    hinted = True
                except KeyError:
                    lost = vm.replicas.pop(src, None)    # read-repair (§4.5)
                    if lost is not None:
                        lost.unbind_index()
                    if self.ledger is not None:
                        self.ledger.on_replica_drop(op.bucket, op.key, src,
                                                    now, version=vm.version)
                    if not vm.replicas:
                        raise
        for _attempt in range(0 if hinted else len(self.backends) + 1):
            try:
                vm, src, hit = self.meta.locate(op.bucket, op.key, op.region,
                                                now, op.version)
            except ApiError as e:
                if e.code == "ServiceUnavailable" and self.ledger is not None:
                    self.ledger.count_unavailable()   # §6.4: 503'd GET
                raise
            check_preconditions(vm.etag, op.if_match, op.if_none_match)
            rng = resolve_range(op.range_, vm.size)
            try:
                if hit and rng is not None:
                    # local ranged read: only the slice leaves the backend
                    body = self.backends[src].get(
                        op.bucket, self._pkey(op.key, vm.version), rng)
                else:
                    full = self.backends[src].get(
                        op.bucket, self._pkey(op.key, vm.version))
                break
            except KeyError:
                lost = vm.replicas.pop(src, None)    # physical bytes lost
                if lost is not None:
                    lost.unbind_index()
                if self.ledger is not None:
                    self.ledger.on_replica_drop(op.bucket, op.key, src, now,
                                                version=vm.version)
                if not vm.replicas:
                    raise
        if self.policy is not None:
            action = self._policy_get_bookkeeping(
                op, vm, src, hit, full, now, _hints if hinted else None, _k)
        else:
            action = "keep" if hit else "store"   # built-in replicate-on-read
            if self.ledger is not None:
                self.ledger.count_get(hit)
                self.ledger.charge_op(op.region, "GET")
                self.ledger.record_get_latency(src, op.region, float(vm.size))
                if not hit:   # replicate-on-read: egress + a new local copy
                    self.ledger.charge_transfer(src, op.region, vm.size)
                    if op.region not in self.unavailable:
                        self.ledger.count_replication()
            self.meta.record_get(op.bucket, op.key, op.region, vm.size, hit, now)
            if hit:
                self.meta.touch_replica(op.bucket, op.key, op.region, now)
            else:
                # replicate-on-read always copies the whole object (a ranged
                # miss still seeds a full local replica): egress = full size
                self.transfers.add(self.cost, src, op.region, vm.size)
                if op.region not in self.unavailable:
                    # §6.4: a downed landing region serves the bytes (the
                    # failover egress above) but cannot take a local copy.
                    h = self.backends[op.region].put(
                        op.bucket, self._pkey(op.key, vm.version), full)
                    self.meta.commit_replica(op.bucket, op.key, op.region,
                                             vm.size, h.etag, now)
        if body is None:
            body = full if rng is None else full[rng[0]:rng[1] + 1]
        return GetResponse(
            body=body, etag=vm.etag, size=vm.size,
            last_modified=vm.last_modified, version=vm.version,
            content_range=(rng[0], rng[1], vm.size) if rng is not None else None,
            source_region=src, hit=hit, placement_action=action,
        )

    # -- policy-driven placement (the Simulator's decision surface, live) -----
    def _obj_id(self, key: str) -> int:
        """Dense integer object id for ``key`` (the metadata server's
        :class:`~repro_torch.core.expiry.KeyInterner`).  Numeric trace keys keep
        their integer value -- the id the Simulator uses -- so both planes
        index the same policy statistics; arbitrary string keys get stable
        dense ids, so oracle-style per-object policies work beyond
        trace-shaped keys."""
        return self.meta.interner.intern(key)

    def _committed_count(self, vm) -> int:
        return sum(1 for m in vm.replicas.values() if m.status == COMMITTED)

    def _sole_reachable(self, vm, region: str) -> bool:
        """§6.4 guard predicate (mirror of ``Simulator._sole_reachable``):
        is ``region``'s replica the version's last reachable committed copy
        while an outage is active?  Always False with no outage."""
        return bool(self.unavailable) and not any(
            r for r, m in vm.replicas.items()
            if (r != region and m.status == COMMITTED
                and r not in self.unavailable))

    def _evict_replica(self, bucket: str, key: str, region: str, now: float,
                       count_eviction: bool = False) -> None:
        version = self.meta.drop_replica(bucket, key, region, now,
                                         count_eviction=count_eviction)
        if version is not None:
            self.backends[region].delete(bucket, self._pkey(key, version))

    def _policy_get_bookkeeping(self, op: GetRequest, vm, src: str, hit: bool,
                                full: Optional[bytes], now: float,
                                _hints=None, _k: int = -1) -> str:
        """Mirror of ``Simulator._handle_get``: observe, then replicate-on-
        read / TTL-re-arm / evict exactly as the policy dictates.  Returns
        the placement action taken ("store"/"skip" on a miss, "keep"/"evict"
        on a hit) -- the same label the simulator records per GET, so the
        replay harness diffs clairvoyant store/evict-now choices too.

        When the GET was served off a fresh routing hint, ``_hints``/``_k``
        supply the chunk-vectorized GET-op and egress charge values (bit-
        identical to the scalar formulas; accumulated here in event order)."""
        oid = self._obj_id(op.key)
        if self.ledger is not None:
            self.ledger.count_get(hit)
            if _hints is not None:
                self.ledger.charge_op_value(_hints.op_cost[_k])
            else:
                self.ledger.charge_op(op.region, "GET")
        gap_key = (op.bucket, op.key, op.region)
        prev = self._last_get.get(gap_key)
        gap = (now - prev) if prev is not None else None
        ctx = GetContext(oid, op.bucket, op.region, src, float(vm.size), now,
                         hit, gap)
        self.policy.observe_get(ctx)
        holders = self.meta.holders(op.bucket, op.key)
        action = "skip"
        if not hit:
            # §6.4 failover egress: the cheapest *live* source may be a
            # pricier edge; both planes charge the same one.
            self.transfers.add(self.cost, src, op.region, vm.size)
            if self.ledger is not None:
                if _hints is not None:
                    self.ledger.charge_transfer_value(_hints.egress[_k])
                else:
                    self.ledger.charge_transfer(src, op.region, vm.size)
            # A downed landing region cannot take the replicate-on-read
            # copy; the policy is not consulted (Simulator._handle_get
            # short-circuits identically).
            if op.region not in self.unavailable and self.policy.cache_on_read(ctx):
                if self.ledger is not None:
                    self.ledger.count_replication()
                ttl = self.policy.ttl_on_access(ctx, holders)
                if ttl > 0:
                    if full is None:   # ranged miss still seeds a full copy
                        full = self.backends[src].get(
                            op.bucket, self._pkey(op.key, vm.version))
                    h = self.backends[op.region].put(
                        op.bucket, self._pkey(op.key, vm.version), full)
                    self.meta.commit_replica(op.bucket, op.key, op.region,
                                             vm.size, h.etag, now, ttl=ttl)
                    action = "store"
        else:
            rm = vm.replicas[op.region]
            if not rm.pinned:
                ttl = self.policy.ttl_on_access(ctx, holders)
                if (ttl <= 0
                        and (self.mode != "FP"
                             or self._committed_count(vm) > self.min_fp_copies)
                        and not self._sole_reachable(vm, op.region)):
                    self._evict_replica(op.bucket, op.key, op.region, now,
                                        count_eviction=True)
                    action = "evict"
                else:
                    self.meta.touch_replica(op.bucket, op.key, op.region, now,
                                            ttl=ttl)
                    action = "keep"
            else:
                rm.last_access = now
                action = "keep"
        self._last_get[gap_key] = now
        self._open_last.setdefault((op.bucket, op.region), {})[oid] = (
            now, float(vm.size))
        if self.ledger is not None:
            # §6.3: mirrored point of the simulator's end-of-_handle_get
            # append -- same (src, dst, size) triple, same formula owner.
            self.ledger.record_get_latency(src, op.region, float(vm.size))
        return action

    def last_access_snapshot(self):
        """Same shape as ``Simulator.last_access_snapshot`` -- consumed by
        ``Policy.periodic`` (e.g. SkyStore's daily histogram refresh)."""
        return self._open_last

    def policy_tick(self, now: float) -> None:
        """One maintenance tick of the policy-driven live plane: the §4.2
        eviction scan followed by the policy's periodic hook -- the exact
        sequence ``Simulator.run`` performs at every ``scan_interval``."""
        self.run_eviction_scan(now)
        if self.policy is not None:
            self.policy.periodic(now, self)

    def apply_replica_sets(self, replica_sets: Dict[str, Tuple[str, ...]],
                           now: float) -> int:
        """Epoch boundary of an epoch-solver policy (SPANStore, §6.2.2):
        drop committed replicas outside the solver's new per-bucket sets,
        keeping at least ``min_fp_copies`` copies -- the live-plane mirror
        of ``Simulator._apply_spanstore_sets``.  §6.4: replicas in downed
        regions cannot be deleted (the first boundary after recovery
        collects them) and the last reachable copy is never dropped.
        Returns the number of replicas evicted."""
        dropped = 0
        for (bucket, key), om in list(self.meta.objects.items()):
            rs = replica_sets.get(bucket)
            vm = om.latest
            if not rs or vm is None:
                continue
            keep = set(rs)
            for r in list(vm.replicas):
                if (r in keep or r in self.unavailable
                        or vm.replicas[r].status != COMMITTED
                        or self._committed_count(vm) <= self.min_fp_copies
                        or self._sole_reachable(vm, r)):
                    continue
                self._evict_replica(bucket, key, r, now, count_eviction=True)
                dropped += 1
        return dropped

    # -- §6.4 failure plane ----------------------------------------------------
    def region_down(self, region: str, now: Optional[float] = None) -> None:
        """REGION_DOWN handler (event spine / operator): ``region``'s
        storage is unreachable from here on -- GETs fail over, PUTs
        redirect, its replicas are shielded from eviction."""
        now = self._clock() if now is None else now
        self.unavailable.add(region)
        if self.meta.routing is not None:
            self.meta.routing.set_outage(region, True)
        if self.policy is not None:
            self.policy.region_available(region, False, now)

    def region_up(self, region: str, now: Optional[float] = None) -> None:
        """REGION_UP handler: ``region`` is reachable again.  Deferred §4.4
        base syncs replay *before* the policy hook fires, so a policy
        observing holders sees the post-recovery placement."""
        now = self._clock() if now is None else now
        self.unavailable.discard(region)
        if self.meta.routing is not None:
            self.meta.routing.set_outage(region, False)
        self._drain_pending_syncs(now)
        if self.policy is not None:
            self.policy.region_available(region, True, now)

    def _drain_pending_syncs(self, now: float) -> None:
        """Replay deferred §4.4 base syncs (mirror of
        ``Simulator._drain_pending_syncs``): every recovery is a chance --
        the recovering region may be the missing base *or* the only live
        source.  Iterated in interned-object-id order, the same sequence
        the simulator uses."""
        for bk in sorted(self._pending_sync, key=lambda bk: self._obj_id(bk[1])):
            bucket, key = bk
            landing = self._pending_sync[bk]
            om = self.meta.objects.get(bk)
            vm = om.latest if om is not None else None
            if vm is None or not any(m.status == COMMITTED
                                     for m in vm.replicas.values()):
                del self._pending_sync[bk]
                continue
            base = om.base_region
            if base is None or base in self.unavailable:
                continue                    # base still dark: keep waiting
            if (base in vm.replicas
                    and vm.replicas[base].status == COMMITTED):
                del self._pending_sync[bk]   # a newer PUT already landed there
                continue
            holders = {r: e for r, e in self.meta.holders(bucket, key).items()
                       if r not in self.unavailable}
            if not holders:
                continue                    # sources dark: retry at next UP
            src = self.cost.cheapest_source(holders, base)
            pkey = self._pkey(key, vm.version)
            data = self.backends[src].get(bucket, pkey)
            self.transfers.add(self.cost, src, base, vm.size)
            if self.ledger is not None:
                self.ledger.charge_transfer(src, base, vm.size)
                self.ledger.charge_op(base, "PUT")
                self.ledger.count_replication()
            self.backends[base].put(bucket, pkey, data)
            self.meta.commit_replica(bucket, key, base, vm.size, vm.etag,
                                     now, ttl=float("inf"))
            del self._pending_sync[bk]
            # The landing copy demotes to a cache replica with a policy TTL
            # -- the synchronous §4.4 rule, applied at recovery time.
            rm = vm.replicas.get(landing)
            if (self.policy is not None and rm is not None and not rm.pinned
                    and landing not in self.unavailable):
                ctx = GetContext(self._obj_id(key), bucket, landing, base,
                                 float(vm.size), now, hit=True, gap=None)
                ttl = self.policy.ttl_on_access(
                    ctx, self.meta.holders(bucket, key))
                if ttl <= 0:
                    self._evict_replica(bucket, key, landing, now)
                else:
                    self.meta.touch_replica(bucket, key, landing, now, ttl=ttl)

    def _handle_head(self, op: HeadRequest) -> HeadResponse:
        om = self.meta.head_object(op.bucket, op.key)
        vm = om.latest
        if vm is None:
            raise ApiError("NoSuchKey", f"{op.bucket}/{op.key} not found")
        check_preconditions(vm.etag, op.if_match, op.if_none_match)
        if self.ledger is not None:
            self.ledger.count_head()
            self.ledger.charge_op(op.region, "HEAD")
        return HeadResponse(op.key, vm.size, vm.etag, vm.last_modified,
                            vm.version)

    def _handle_list(self, op: ListRequest) -> ListResponse:
        """Paginated ListObjectsV2 with delimiter roll-up, straight off the
        metadata table (no per-key HEAD round trips)."""
        if op.bucket not in self.meta.buckets:
            raise ApiError("NoSuchBucket", f"no such bucket {op.bucket!r}")
        if self.ledger is not None:
            self.ledger.count_list()
            self.ledger.charge_op(op.region, "LIST")
        start_after = (decode_continuation_token(op.continuation_token)
                       if op.continuation_token else "")
        max_keys = max(0, min(op.max_keys, MAX_LIST_KEYS))
        contents: List[ObjectSummary] = []
        prefixes: List[str] = []
        seen_prefixes = set()
        truncated = False
        last_item = ""
        for om in self.meta.list_objects(op.bucket, op.prefix):
            vm = om.latest
            if vm is None:
                continue             # 2PC in flight: not visible yet (§4.5)
            # Derive the listing entry: a rolled-up common prefix or the key.
            entry_key = None
            if op.delimiter:
                rest = om.key[len(op.prefix):]
                i = rest.find(op.delimiter)
                if i >= 0:
                    entry_key = op.prefix + rest[:i + len(op.delimiter)]
            name = entry_key or om.key
            if start_after and name <= start_after:
                continue
            if entry_key is not None and entry_key in seen_prefixes:
                continue
            if len(contents) + len(prefixes) >= max_keys:
                truncated = max_keys > 0
                break
            if entry_key is not None:
                seen_prefixes.add(entry_key)
                prefixes.append(entry_key)
            else:
                contents.append(ObjectSummary(om.key, vm.size, vm.etag,
                                              vm.last_modified))
            last_item = name
        token = encode_continuation_token(last_item) if truncated else None
        return ListResponse(contents, prefixes, truncated, token)

    def _handle_delete_object(self, op: DeleteObjectRequest) -> Ack:
        if (op.bucket, op.key) not in self.meta.objects:
            raise ApiError("NoSuchKey", f"{op.bucket}/{op.key} not found")
        now = self._now(op)
        if self.ledger is not None:
            om = self.meta.objects[(op.bucket, op.key)]
            region = op.region or om.base_region or self.cost.region_names()[0]
            self.ledger.charge_op(region, "DELETE")
        for region, version in self.meta.delete_object(op.bucket, op.key, now):
            self.backends[region].delete(op.bucket, self._pkey(op.key, version))
        return Ack()

    def _handle_delete_objects(self, op: DeleteObjectsRequest) -> DeleteObjectsResponse:
        deleted: List[str] = []
        errors: List[Tuple[str, str]] = []
        for key in op.keys:
            try:
                self._handle_delete_object(
                    DeleteObjectRequest(op.bucket, key, op.region, op.at))
                deleted.append(key)
            except ApiError as e:
                if e.code == "NoSuchKey":
                    deleted.append(key)      # batch delete is idempotent (S3)
                else:
                    errors.append((key, e.code))
        return DeleteObjectsResponse(deleted, errors)

    def _handle_copy(self, op: CopyRequest) -> CopyResponse:
        """COPY short-circuit: if a committed replica of the source already
        sits in the destination region -- even one whose TTL has lapsed but
        that the eviction scan has not yet collected -- read it locally
        instead of paying the replicate-on-read transfer."""
        now = self._now(op)
        om = self.meta.head_object(op.bucket, op.src_key)
        vm = om.latest
        if vm is None:
            raise ApiError("NoSuchKey", f"{op.bucket}/{op.src_key} not found")
        local = vm.replicas.get(op.region)
        data = None
        if local is not None and local.status == COMMITTED:
            try:
                data = self.backends[op.region].get(
                    op.bucket, self._pkey(op.src_key, vm.version))
                self.meta.touch_replica(op.bucket, op.src_key, op.region, now)
            except KeyError:
                lost = vm.replicas.pop(op.region, None)   # read-repair (§4.5)
                if lost is not None:
                    lost.unbind_index()
                if self.ledger is not None:
                    self.ledger.on_replica_drop(op.bucket, op.src_key,
                                                op.region, now,
                                                version=vm.version)
        if data is None:
            data = self._handle_get(
                GetRequest(op.bucket, op.src_key, op.region, at=op.at)).body
        put = self._handle_put(
            PutRequest(op.bucket, op.dst_key, op.region, body=data, at=op.at))
        return CopyResponse(put.version, put.etag)

    # -- multipart upload ------------------------------------------------------
    def _part_key(self, upload_id: str, part_number: int) -> str:
        return f"{MPU_PREFIX}{upload_id}/{part_number:05d}"

    def _handle_create_mpu(self, op: CreateMultipartRequest) -> CreateMultipartResponse:
        if op.bucket not in self.meta.buckets:
            raise ApiError("NoSuchBucket", f"no such bucket {op.bucket!r}")
        uid = hashlib.md5(
            f"{op.bucket}/{op.key}/{op.region}/{self._now(op)}".encode()
        ).hexdigest()
        self._mpu[uid] = _MultipartUpload(op.bucket, op.key, op.region)
        return CreateMultipartResponse(uid)

    def _handle_upload_part(self, op: UploadPartRequest) -> UploadPartResponse:
        mpu = self._mpu.get(op.upload_id)
        if mpu is None:
            raise ApiError("NoSuchUpload", f"no upload {op.upload_id!r}")
        if op.part_number < 1:
            raise ApiError("InvalidPart",
                           f"part numbers start at 1, got {op.part_number}")
        # Spill to the local-region backend: proxy RAM holds one part at most.
        h = self.backends[mpu.region].put(
            mpu.bucket, self._part_key(op.upload_id, op.part_number), op.body)
        mpu.parts[op.part_number] = (h.etag, len(op.body))
        return UploadPartResponse(h.etag)

    def _handle_complete_mpu(self, op: CompleteMultipartRequest) -> CompleteMultipartResponse:
        mpu = self._mpu.get(op.upload_id)
        if mpu is None or (mpu.bucket, mpu.key) != (op.bucket, op.key):
            raise ApiError("NoSuchUpload", f"no upload {op.upload_id!r} for "
                                           f"{op.bucket}/{op.key}")
        if op.parts is None:
            listed = [(n, mpu.parts[n][0]) for n in sorted(mpu.parts)]
        else:
            listed = [(int(n), e) for n, e in op.parts]
        if not listed:
            raise ApiError("InvalidPart", "empty part list")
        numbers = [n for n, _e in listed]
        if numbers != sorted(set(numbers)):
            raise ApiError("InvalidPartOrder",
                           "part numbers must be unique and ascending")
        for n, etag in listed:
            have = mpu.parts.get(n)
            if have is None:
                raise ApiError("InvalidPart", f"part {n} was never uploaded")
            if etag and etag.strip('"') != have[0]:
                raise ApiError("InvalidPart", f"part {n} ETag mismatch")
        # Streaming assembly: parts are read back in bounded chunks and piped
        # straight into the destination blob, so completing an N-GB upload
        # holds one chunk in proxy RAM -- never the whole object.
        total = sum(mpu.parts[n][1] for n, _e in listed)
        now = self._now(op)

        def assembled():
            src = self.backends[mpu.region]
            step = self.mpu_chunk_size
            for n, _e in listed:
                pkey = self._part_key(op.upload_id, n)
                psize = mpu.parts[n][1]
                for off in range(0, psize, step):
                    yield src.get(mpu.bucket, pkey,
                                  (off, min(off + step, psize) - 1))

        put = self._put_streamed(op.bucket, op.key, mpu.region, assembled(),
                                 total, now)
        self._discard_mpu(op.upload_id)
        return CompleteMultipartResponse(put.version, put.etag, total)

    def _put_streamed(self, bucket: str, key: str, region: str, chunks,
                      size: int, now: float) -> PutResponse:
        """The PUT pipeline fed by a chunk iterator instead of one bytes
        object (multipart completion).  Same 2PC + ledger + policy mechanics
        as :meth:`_handle_put`; replication targets re-read the committed
        local blob in bounded chunks, so nothing on this path ever
        materializes the whole object in proxy RAM."""
        if self.ledger is not None:
            self.ledger.count_put()
            self.ledger.charge_op(region, "PUT")
            # Multipart uploads land where they were created: origin ==
            # landing region, so the latency edge is intra-region.
            self.ledger.record_put_latency(region, region, float(size))
        stale = self._stale_blobs(bucket, key) if self.policy is not None else []
        version = self.meta.begin_upload(bucket, key, region, size, now)
        pkey = self._pkey(key, version)
        h = self.backends[region].put_stream(bucket, pkey, chunks)
        self.meta.complete_upload(bucket, key, region, version, size,
                                  h.etag, now)
        if self.policy is not None:
            def replicate_to(dst: str) -> None:
                # Source from a region that still holds the blob: the
                # mechanics may have already evicted the write-local copy
                # (policy ttl <= 0) before replicate_on_write targets run.
                src = self._holder_region(bucket, key, prefer=region)
                self.backends[dst].put_stream(
                    bucket, pkey, self._read_chunks(src, bucket, pkey, size))

            self._policy_put_mechanics(
                bucket, key, region, size, h.etag, version, stale, now,
                write_to=replicate_to,
            )
        return PutResponse(version, h.etag)

    def _holder_region(self, bucket: str, key: str, prefer: str) -> str:
        """A region whose committed replica of the latest version still has
        physical bytes (``prefer`` if it qualifies)."""
        vm = self.meta.objects[(bucket, key)].latest
        if prefer in vm.replicas and vm.replicas[prefer].status == COMMITTED:
            return prefer
        for r, m in vm.replicas.items():
            if m.status == COMMITTED:
                return r
        raise ApiError("NoSuchKey", f"{bucket}/{key} has no committed replica")

    def _read_chunks(self, region: str, bucket: str, pkey: str, size: int):
        """Ranged reads of a committed blob in ``mpu_chunk_size`` steps --
        the bounded-RAM replication source for streamed PUTs."""
        be = self.backends[region]
        step = self.mpu_chunk_size
        for off in range(0, size, step):
            yield be.get(bucket, pkey, (off, min(off + step, size) - 1))

    def _handle_abort_mpu(self, op: AbortMultipartRequest) -> Ack:
        self._discard_mpu(op.upload_id)
        return Ack()

    def _discard_mpu(self, upload_id: str) -> None:
        mpu = self._mpu.pop(upload_id, None)
        if mpu is None:
            return
        for n in mpu.parts:
            self.backends[mpu.region].delete(mpu.bucket,
                                             self._part_key(upload_id, n))

    # -- legacy keyword surface (thin wrappers over dispatch) -----------------
    def create_bucket(self, bucket: str) -> None:
        self.dispatch(CreateBucketRequest(bucket))

    def list_buckets(self) -> List[str]:
        return self.dispatch(ListBucketsRequest()).buckets

    def delete_bucket(self, bucket: str) -> None:
        self.dispatch(DeleteBucketRequest(bucket))

    def put_object(self, bucket: str, key: str, data: bytes, region: str) -> int:
        return self.dispatch(PutRequest(bucket, key, region, body=data)).version

    def get_object(self, bucket: str, key: str, region: str,
                   version: Optional[int] = None) -> bytes:
        return self.dispatch(GetRequest(bucket, key, region,
                                        version=version)).body

    def head_object(self, bucket: str, key: str) -> HeadResult:
        r = self.dispatch(HeadRequest(bucket, key))
        return HeadResult(r.key, r.size, r.etag, r.last_modified)

    def list_objects(self, bucket: str, prefix: str = "") -> List[str]:
        keys: List[str] = []
        token = None
        while True:
            r = self.dispatch(ListRequest(bucket, prefix,
                                          continuation_token=token))
            keys.extend(s.key for s in r.contents)
            if not r.is_truncated:
                return keys
            token = r.next_continuation_token

    def delete_object(self, bucket: str, key: str) -> None:
        self.dispatch(DeleteObjectRequest(bucket, key))

    def delete_objects(self, bucket: str, keys: Iterable[str]) -> None:
        self.dispatch(DeleteObjectsRequest(bucket, list(keys)))

    def copy_object(self, bucket: str, src_key: str, dst_key: str, region: str) -> int:
        return self.dispatch(CopyRequest(bucket, src_key, dst_key, region)).version

    def create_multipart_upload(self, bucket: str, key: str, region: str) -> str:
        return self.dispatch(CreateMultipartRequest(bucket, key, region)).upload_id

    def upload_part(self, upload_id: str, part_number: int, data: bytes) -> str:
        return self.dispatch(UploadPartRequest(upload_id, part_number,
                                               bytes(data))).etag

    def complete_multipart_upload(self, bucket: str, key: str, region: str,
                                  upload_id: str) -> int:
        return self.dispatch(CompleteMultipartRequest(bucket, key, region,
                                                      upload_id)).version

    def abort_multipart_upload(self, upload_id: str) -> None:
        self.dispatch(AbortMultipartRequest(upload_id))

    # -- maintenance ---------------------------------------------------------------
    def run_eviction_scan(self, now: Optional[float] = None) -> int:
        """The §4.2 background process: metadata scan + physical DELETEs.
        O(expired) off the shared expiry index."""
        now = self._clock() if now is None else now
        victims = self.meta.scan_expired(now)
        for bucket, key, region, version in victims:
            self.backends[region].delete(bucket, self._pkey(key, version))
        self.meta.expire_pending(now)
        return len(victims)

    def expire_replica(self, ident, texp: float) -> bool:
        """EXPIRE handler for the event spine (:mod:`repro_torch.core.engine`):
        apply one expiry already popped off ``meta.expiry`` -- metadata drop
        plus the physical DELETE.  Returns True if a replica was dropped."""
        victim = self.meta.expire_replica(ident, texp)
        if victim is None:
            return False
        bucket, key, region, version = victim
        self.backends[region].delete(bucket, self._pkey(key, version))
        return True

    def expire_replicas(self, pops) -> int:
        """EXPIRE-round handler for the batched spine
        (:meth:`EventSpine.iter_batches`): one drain round through
        :meth:`MetadataServer.expire_batch` (ledger charges vectorized),
        then the physical DELETEs in victim order.  Returns the number of
        replicas dropped."""
        victims = self.meta.expire_batch(pops)
        for bucket, key, region, version in victims:
            self.backends[region].delete(bucket, self._pkey(key, version))
        return len(victims)

    def backup_metadata(self, bucket: str, region: str) -> None:
        """Checkpoint the control plane *into* the object layer (§4.5)."""
        blob = self.meta.backup()
        self.backends[region].put(bucket, "__skystore_meta__/backup.json", blob)

    @classmethod
    def recover(
        cls, cost: CostModel, backends: Dict[str, Backend], bucket: str,
        region: str, mode: str = "FB", device="cuda",
    ) -> "VirtualStore":
        """Bring up a fresh metadata server from the latest backup, then
        reconcile against the physical stores (§4.5 failure recovery)."""
        try:
            blob = backends[region].get(bucket, "__skystore_meta__/backup.json")
            meta = MetadataServer.restore(blob, cost, mode=mode, device=device)
        except KeyError:
            meta = MetadataServer(cost, mode=mode, device=device)
            meta.create_bucket(bucket)
        vs = cls(cost, backends, meta, mode=mode, device=device)
        meta.reconcile(backends)
        return vs

    # -- internals --------------------------------------------------------------------
    @staticmethod
    def _pkey(key: str, version: int) -> str:
        return f"{key}@v{version}"

    def replica_regions(self, bucket: str, key: str) -> List[str]:
        om = self.meta.head_object(bucket, key)
        return sorted(
            r for r, m in om.latest.replicas.items() if m.status == COMMITTED
        )

    _HANDLERS = {
        CreateBucketRequest: "_handle_create_bucket",
        DeleteBucketRequest: "_handle_delete_bucket",
        ListBucketsRequest: "_handle_list_buckets",
        PutRequest: "_handle_put",
        GetRequest: "_handle_get",
        HeadRequest: "_handle_head",
        ListRequest: "_handle_list",
        DeleteObjectRequest: "_handle_delete_object",
        DeleteObjectsRequest: "_handle_delete_objects",
        CopyRequest: "_handle_copy",
        CreateMultipartRequest: "_handle_create_mpu",
        UploadPartRequest: "_handle_upload_part",
        CompleteMultipartRequest: "_handle_complete_mpu",
        AbortMultipartRequest: "_handle_abort_mpu",
    }
