"""Live-plane cost accounting: the :class:`CostLedger` and :class:`CostReport`.

The PyTorch port's copy of :mod:`repro.core.ledger`.  The cost simulator and
the live serving path share one semantic rule set (§3.2, §5), so policy costs
measured in simulation transfer to deployment: a :class:`CostLedger` attached
to a live :class:`~repro_torch.core.virtual_store.VirtualStore` /
:class:`~repro_torch.core.metadata.MetadataServer` charges the same
:class:`~repro_torch.core.costmodel.CostModel` per request -- storage GB-months
integrated over each replica's [commit, drop) lifetime, egress per
cross-region GET / base sync / replication, and per-op request charges -- and
produces the same :class:`CostReport` the simulator emits, so the two planes
are directly diffable (see :mod:`repro_torch.core.replay`).

Every charge is a Python or numpy float64 on the host, accumulated one
lifetime at a time in drop order: a ``torch.sum`` (or ``np.sum``) would
reorder the additions and round differently, and the golden fixtures pin
these sums to 1e-9.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .costmodel import GB, SECONDS_PER_MONTH, CostModel

INF = float("inf")


@dataclasses.dataclass
class CostReport:
    policy: str
    mode: str
    storage: float = 0.0        # evictable (cache-side) replica storage
    storage_base: float = 0.0   # pinned FB base replicas -- identical across
    # policies by construction (§3.1 compares cache-side cost + egress only)
    network: float = 0.0
    ops: float = 0.0
    n_get: int = 0
    n_put: int = 0
    n_head: int = 0
    n_list: int = 0
    n_hit: int = 0
    n_miss: int = 0
    n_evictions: int = 0
    n_replications: int = 0
    #: §6.4 failure plane: GETs that 503'd because every replica-holding
    #: region was down.  Deliberately NOT part of :meth:`counters` -- the
    #: pre-outage golden fixtures pin that dict exactly; the replay harness
    #: diffs this field explicitly and reports it in the availability
    #: metric instead.
    n_unavailable: int = 0
    #: §6.4: §4.4 base syncs that were deferred past an outage and replayed
    #: at REGION_UP (same fixture-compat note as ``n_unavailable``).
    n_deferred_syncs: int = 0
    get_latency_ms: List[float] = dataclasses.field(default_factory=list)
    put_latency_ms: List[float] = dataclasses.field(default_factory=list)

    @property
    def total(self) -> float:
        """Full bill, base replicas included."""
        return self.storage + self.storage_base + self.network + self.ops

    @property
    def policy_cost(self) -> float:
        """The §3.1 objective: costs the policy can influence (cache-side
        storage + network + ops).  FB base storage is constant across
        policies and excluded; in FP mode there are no pinned replicas and
        ``policy_cost == total``."""
        return self.storage + self.network + self.ops

    def latency_stats(self) -> Dict[str, float]:
        """Latency percentiles over the tracked per-request streams (§6.3).

        Both planes evaluate the one ``CostModel`` latency formula on the
        same deterministic decision stream, so under replay these stats
        agree *exactly* across planes, not merely within tolerance -- the
        invariant ``DiffReport.latency`` pins."""
        out = {}
        for name, xs in (("get", self.get_latency_ms), ("put", self.put_latency_ms)):
            if xs:
                a = np.asarray(xs)
                out[f"{name}_mean"] = float(a.mean())
                out[f"{name}_p50"] = float(np.percentile(a, 50))
                out[f"{name}_p90"] = float(np.percentile(a, 90))
                out[f"{name}_p99"] = float(np.percentile(a, 99))
        return out

    def components(self) -> Dict[str, float]:
        """The diffable dollar components (used by the replay harness)."""
        return {
            "storage": self.storage,
            "storage_base": self.storage_base,
            "network": self.network,
            "ops": self.ops,
            "total": self.total,
        }

    def counters(self) -> Dict[str, int]:
        return {
            "n_get": self.n_get,
            "n_put": self.n_put,
            "n_head": self.n_head,
            "n_list": self.n_list,
            "n_hit": self.n_hit,
            "n_miss": self.n_miss,
            "n_evictions": self.n_evictions,
            "n_replications": self.n_replications,
        }

    def availability(self) -> Dict[str, float]:
        """The §6.4 availability metric: fraction of GET attempts served
        (vs. 503'd for want of any reachable replica).  ``n_get`` counts
        only *served* GETs, so attempts = served + unavailable."""
        attempts = self.n_get + self.n_unavailable
        return {
            "gets_served": self.n_get,
            "gets_unavailable": self.n_unavailable,
            "deferred_syncs": self.n_deferred_syncs,
            "fraction_served": self.n_get / attempts if attempts else 1.0,
        }

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "mode": self.mode,
            "total": self.total,
            "policy_cost": self.policy_cost,
            "storage": self.storage,
            "storage_base": self.storage_base,
            "network": self.network,
            "ops": self.ops,
            "hit_rate": self.n_hit / max(self.n_get, 1),
        }


@dataclasses.dataclass
class _OpenReplica:
    """An in-flight replica lifetime: committed, not yet dropped."""

    region: str
    start: float
    size: float
    pinned: bool


class CostLedger:
    """Charges the live plane exactly the way the simulator charges itself.

    Replica lifetimes open on ``on_replica_commit`` and close on
    ``on_replica_drop`` (eviction scan, LWW overwrite, DELETE, policy
    decision); storage is integrated over [start, end) capped at the trace
    horizon, exactly mirroring ``Simulator._charge_storage``.  Transfers and
    per-op charges are recorded at the call sites in
    :class:`~repro_torch.core.virtual_store.VirtualStore`.
    """

    def __init__(
        self,
        cost: CostModel,
        policy: str = "live",
        mode: str = "FB",
        horizon: float = 0.0,
        charge_ops: bool = True,
        track_latency: bool = False,
    ) -> None:
        self.cost = cost
        self.horizon = horizon
        self.charge_ops = charge_ops
        self.track_latency = track_latency
        self.report = CostReport(policy, mode)
        self._open: Dict[Tuple[str, str, str], _OpenReplica] = {}

    # -- replica lifetimes ---------------------------------------------------
    # Lifetimes are keyed by (bucket, key, region, version): under a
    # versioning MetadataServer two versions of one key can hold distinct
    # physical replicas in the same region, each billed separately.
    def on_replica_commit(
        self, bucket: str, key: str, region: str, size: float, pinned: bool,
        now: float, version: int = 0,
    ) -> None:
        entry = self._open.get((bucket, key, region, version))
        if entry is not None:
            # Re-commit of a live replica (TTL refresh): the lifetime is
            # continuous -- keep the original start, like the simulator's
            # ``_add_replica`` reuse path.
            entry.pinned = entry.pinned or pinned
            return
        self._open[(bucket, key, region, version)] = _OpenReplica(
            region, now, float(size), pinned)

    def on_replica_drop(
        self, bucket: str, key: str, region: str, end: float,
        count_eviction: bool = False, version: int = 0,
    ) -> None:
        entry = self._open.pop((bucket, key, region, version), None)
        if entry is None:
            return
        self._charge_storage(entry, end)
        if count_eviction:
            self.report.n_evictions += 1

    #: Drop count at which a round's charges go through one vectorized
    #: numpy evaluation (same threshold role as
    #: ``Simulator._VEC_CHARGE_MIN``; identical floats either way).
    _VEC_CHARGE_MIN = 8

    def on_replica_drop_batch(
        self, drops: List[Tuple[str, str, str, float, int]],
        count_eviction: bool = True,
    ) -> None:
        """One expiry round's drops, ``(bucket, key, region, end, version)``
        each: close the lifetimes in drop order and apply the storage
        charges in a single vectorized pass.  The per-entry products and the
        accumulation order mirror :meth:`on_replica_drop` called in the same
        sequence, so the report's float trajectory is bit-identical -- this
        batch entry point exists purely to take the per-drop Python
        arithmetic out of the spine's drain rounds."""
        entries: List[Tuple[_OpenReplica, float]] = []
        for bucket, key, region, end, version in drops:
            entry = self._open.pop((bucket, key, region, version), None)
            if entry is None:
                continue
            if count_eviction:
                self.report.n_evictions += 1
            entries.append((entry, end))
        if not entries:
            return
        if len(entries) < self._VEC_CHARGE_MIN:
            for entry, end in entries:
                self._charge_storage(entry, end)
            return
        horizon = self.horizon
        end = np.asarray([e for _entry, e in entries])
        if horizon:
            end = np.minimum(end, horizon)
        start = np.asarray([entry.start for entry, _e in entries])
        size = np.asarray([entry.size for entry, _e in entries])
        price = np.asarray(
            [self.cost.storage_price(entry.region) for entry, _e in entries])
        # Elementwise mirror of CostModel.storage_cost (same factors, same
        # association); sequential accumulation -- np.sum's pairwise
        # reduction would round differently.
        costs = price * (size / GB) * (np.maximum(end - start, 0.0)
                                       / SECONDS_PER_MONTH)
        for (entry, _e), c in zip(entries, costs):
            if entry.pinned:
                self.report.storage_base += float(c)
            else:
                self.report.storage += float(c)

    def _charge_storage(self, entry: _OpenReplica, end: float) -> None:
        end = min(end, self.horizon) if self.horizon else end
        c = self.cost.storage_cost(entry.region, entry.size, end - entry.start)
        if entry.pinned:
            self.report.storage_base += c
        else:
            self.report.storage += c

    # -- money ---------------------------------------------------------------
    def charge_transfer(self, src: str, dst: str, nbytes: float) -> None:
        self.report.network += self.cost.transfer_cost(src, dst, nbytes)

    def charge_op(self, region: Optional[str], op: str) -> None:
        if self.charge_ops and region is not None:
            self.report.ops += self.cost.op_cost(region, op)

    # Precomputed-value variants: the routing matrix's route_chunk evaluates
    # a whole DATA chunk's GET/egress charges as numpy vectors whose elements
    # mirror transfer_cost/op_cost term for term (bit-identical floats); the
    # consumer accumulates them here one event at a time, in event order, so
    # the report's float trajectory matches the scalar calls exactly.
    def charge_transfer_value(self, value: float) -> None:
        self.report.network += value

    def charge_op_value(self, value: float) -> None:
        if self.charge_ops:
            self.report.ops += value

    # -- latency (§6.3) ------------------------------------------------------
    # The live half of the latency plane's symmetry discipline: the
    # simulator appends CostModel.{get,put}_latency_ms at the end of its
    # GET/PUT handlers, and the VirtualStore records through these two
    # methods at the mirrored points -- same formula, same (src, dst, size)
    # stream, so the per-request latency lists are identical across planes
    # (the RS005 spirit, applied to latency appends).
    def record_get_latency(self, src: str, dst: str, size: float) -> None:
        if self.track_latency:
            self.report.get_latency_ms.append(
                self.cost.get_latency_ms(src, dst, size))

    def record_put_latency(self, src: str, dst: str, size: float) -> None:
        if self.track_latency:
            self.report.put_latency_ms.append(
                self.cost.put_latency_ms(src, dst, size))

    # -- counters ------------------------------------------------------------
    def count_get(self, hit: bool) -> None:
        self.report.n_get += 1
        self.report.n_hit += int(hit)
        self.report.n_miss += int(not hit)

    def count_put(self) -> None:
        self.report.n_put += 1

    def count_head(self) -> None:
        self.report.n_head += 1

    def count_list(self) -> None:
        self.report.n_list += 1

    def count_replication(self) -> None:
        self.report.n_replications += 1

    def count_unavailable(self) -> None:
        """A GET found no reachable replica (503, §6.4)."""
        self.report.n_unavailable += 1

    def count_deferred_sync(self) -> None:
        """A §4.4 base sync was queued past an outage (replayed at
        recovery; the transfer/op charges land when it actually runs)."""
        self.report.n_deferred_syncs += 1

    # -- end of replay -------------------------------------------------------
    def finalize(self, horizon: float, meta=None) -> CostReport:
        """Close every still-open lifetime at ``min(expire, horizon)`` --
        the simulator's end-of-run flush.  ``meta`` (a MetadataServer) is
        consulted for each surviving replica's expiry; pinned replicas and
        replicas with infinite TTL charge through to the horizon."""
        self.horizon = self.horizon or horizon
        for (bucket, key, region, version), entry in sorted(self._open.items()):
            end = horizon
            if meta is not None:
                om = meta.objects.get((bucket, key))
                vm = next((v for v in om.versions if v.version == version),
                          None) if om is not None else None
                rm = vm.replicas.get(region) if vm is not None else None
                if rm is not None and not rm.pinned:
                    end = min(rm.expire, horizon)
            self._charge_storage(entry, end)
        self._open.clear()
        return self.report
