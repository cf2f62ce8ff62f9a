"""Cost accounting shared by the planes: :class:`CostReport`.

The PyTorch port's copy of the :class:`CostReport` half of
:mod:`repro.core.ledger` -- the currency the simulator settles its charges
into, and what the golden replay fixtures pin.  The live plane's per-request
``CostLedger`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


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
