"""Cloud pricing model (paper §2.1) -- the PyTorch port's copy of
:mod:`repro.core.costmodel`, plain Python with no array library.

Cloud pricing has three components: storage ($/GB/month, region dependent),
network egress ($/GB, edge dependent -- up to 15x spread within a cloud and 19x
across clouds), and per-operation charges (~$0.0004 per 1k requests, usually
negligible; §2.1 footnote 1).  All SkyStore decisions reduce to the ratio

    T_even(src -> dst) = N(src, dst) / S(dst)        (paper Eq. 1, months)

the storage duration at ``dst`` whose cost equals one more transfer over the
``src -> dst`` edge.

Two catalogs ship with the framework:

* :func:`default_catalog` -- the 9 cloud regions used in the paper's 3/6/9-region
  experiments with Sept-2023-era prices (paper footnotes 2-5).
* :func:`tpu_tier_catalog` -- the TPU-serving adaptation: tiers
  HBM / host DRAM / regional object store, where "storage" is occupancy
  (GB-seconds of a scarce tier) and "network" is transfer time.  The same
  T_even calculus applies unchanged.

Internally the simulator uses *seconds* for time and *bytes* for size; prices
are kept in $/GB/month and $/GB and converted at the accounting boundary.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Sequence, Tuple

SECONDS_PER_MONTH = 30.0 * 24 * 3600.0
GB = 1024.0**3


@dataclasses.dataclass(frozen=True)
class Region:
    """A physical cloud region (one node of the placement graph, Fig. 2)."""

    name: str                       # e.g. "aws:us-east-1"
    storage_price: float            # $/GB/month  (standard class)
    put_price: float = 5e-6         # $/request
    get_price: float = 4e-7         # $/request
    # Latency model for Table-6 style end-to-end estimates.
    first_byte_ms: float = 25.0     # intra-region time-to-first-byte
    intra_gbps: float = 8.0         # intra-region throughput (Gbit/s)

    @property
    def provider(self) -> str:
        return self.name.split(":", 1)[0]


class CostModel:
    """Pricing catalog: regions + the directed egress-price matrix.

    ``egress[src][dst]`` is $/GB moved out of ``src`` into ``dst``.  Intra-region
    traffic is free.  The matrix is dense and directed (cloud pricing is
    asymmetric); entries default through :meth:`_default_egress` from provider
    relationships when not given explicitly.
    """

    def __init__(
        self,
        regions: Sequence[Region],
        egress: Mapping[Tuple[str, str], float] | None = None,
        inter_region_rtt_ms: float = 60.0,
        cross_cloud_rtt_ms: float = 90.0,
        inter_gbps: float = 4.0,
    ) -> None:
        self.regions: Dict[str, Region] = {r.name: r for r in regions}
        if len(self.regions) != len(regions):
            raise ValueError("duplicate region names")
        self._egress: Dict[Tuple[str, str], float] = {}
        for a in self.regions.values():
            for b in self.regions.values():
                if a.name == b.name:
                    self._egress[(a.name, b.name)] = 0.0
                else:
                    self._egress[(a.name, b.name)] = self._default_egress(a, b)
        if egress:
            for k, v in egress.items():
                if k[0] not in self.regions or k[1] not in self.regions:
                    raise KeyError(f"unknown region in egress override {k}")
                self._egress[k] = float(v)
        self.inter_region_rtt_ms = inter_region_rtt_ms
        self.cross_cloud_rtt_ms = cross_cloud_rtt_ms
        self.inter_gbps = inter_gbps

    # -- prices ------------------------------------------------------------
    @staticmethod
    def _default_egress(src: Region, dst: Region) -> float:
        # Paper §2.1: cross-cloud transfers cost on average 23x intra-cloud.
        if src.provider == dst.provider:
            return 0.02       # $/GB, intra-cloud inter-region (e.g. AWS us-e1->us-w1)
        return 0.09           # $/GB, cross-cloud internet egress

    def storage_price(self, region: str) -> float:
        return self.regions[region].storage_price

    def egress_price(self, src: str, dst: str) -> float:
        return self._egress[(src, dst)]

    def t_even_months(self, src: str, dst: str) -> float:
        """Break-even storage duration at ``dst`` for the ``src``->``dst`` edge."""
        s = self.storage_price(dst)
        return self.egress_price(src, dst) / s if s > 0 else math.inf

    def t_even_seconds(self, src: str, dst: str) -> float:
        return self.t_even_months(src, dst) * SECONDS_PER_MONTH

    # -- accounting helpers (simulator boundary) ----------------------------
    def storage_cost(self, region: str, size_bytes: float, dur_seconds: float) -> float:
        return (
            self.storage_price(region)
            * (size_bytes / GB)
            * (max(dur_seconds, 0.0) / SECONDS_PER_MONTH)
        )

    def transfer_cost(self, src: str, dst: str, size_bytes: float) -> float:
        return self.egress_price(src, dst) * (size_bytes / GB)

    def op_cost(self, region: str, op: str, n: int = 1) -> float:
        """Per-request charge.  S3 prices requests in two tiers: the mutation
        tier (PUT/COPY/POST/LIST/DELETE, ~$5/M) and the read tier
        (GET/HEAD/SELECT, ~$0.4/M); HEAD bills as a GET."""
        r = self.regions[region]
        tier1 = ("PUT", "COPY", "POST", "LIST", "DELETE")
        return (r.put_price if op.upper() in tier1 else r.get_price) * n

    # -- latency model (Table 6) --------------------------------------------
    def latency_params(self, src: str, dst: str) -> Tuple[float, float]:
        """(ttfb_ms, gbps) for the ``src -> dst`` edge -- the two parameters
        every latency formula derives from.  This is the ONE owner of the
        edge classification (intra-region / same-provider / cross-cloud);
        the dense matrices in :class:`repro_torch.core.routing.RoutingMatrix` are
        built from these exact floats so the vectorized latency terms are
        bit-identical to the scalar ones."""
        r = self.regions[src]
        if src == dst:
            return r.first_byte_ms, r.intra_gbps
        if r.provider == self.regions[dst].provider:
            return r.first_byte_ms + self.inter_region_rtt_ms, self.inter_gbps
        return r.first_byte_ms + self.cross_cloud_rtt_ms, self.inter_gbps

    def get_latency_ms(self, src: str, dst: str, size_bytes: float) -> float:
        """Estimated GET latency serving ``size_bytes`` from ``src`` into ``dst``."""
        ttfb, gbps = self.latency_params(src, dst)
        return ttfb + (size_bytes * 8.0 / (gbps * 1e9)) * 1e3

    def put_latency_ms(self, src: str, dst: str, size_bytes: float) -> float:
        """Estimated PUT latency writing ``size_bytes`` from the client at
        ``src`` into the store at ``dst``: request TTFB + streaming transfer
        + the commit acknowledgement riding the same edge back."""
        ttfb, gbps = self.latency_params(src, dst)
        return ttfb + (size_bytes * 8.0 / (gbps * 1e9)) * 1e3 + ttfb

    # -- views ---------------------------------------------------------------
    def region_names(self) -> Tuple[str, ...]:
        return tuple(self.regions)

    def cheapest_source(self, holders: Iterable[str], dst: str,
                        size_bytes: float = 0.0,
                        latency_weight: float = 0.0) -> str:
        """Cheapest replica-holding source for a read at ``dst`` (§2.3).

        With ``latency_weight > 0`` each holder is scored
        ``egress_price + latency_weight * get_latency_ms`` (the
        latency-vs-egress routing knob); ``latency_weight == 0`` keeps the
        price-only comparison verbatim, so the default decision stream is
        bit-identical to the pre-latency plane.  Ties resolve by sorted
        region name in both scorings -- the contract the vectorized
        :class:`repro_torch.core.routing.RoutingMatrix` mirrors with a
        first-index argmin over the canonically sorted region axis."""
        holders = list(holders)
        if not holders:
            raise ValueError("no replica holds the object")
        if dst in holders:
            return dst
        if latency_weight:
            return min(holders, key=lambda h: (
                self.egress_price(h, dst)
                + latency_weight * self.get_latency_ms(h, dst, size_bytes),
                h))
        return min(holders, key=lambda h: (self.egress_price(h, dst), h))

    def subset(self, names: Sequence[str]) -> "CostModel":
        regions = [self.regions[n] for n in names]
        eg = {
            (a, b): self._egress[(a, b)]
            for a in names
            for b in names
        }
        return CostModel(
            regions,
            eg,
            inter_region_rtt_ms=self.inter_region_rtt_ms,
            cross_cloud_rtt_ms=self.cross_cloud_rtt_ms,
            inter_gbps=self.inter_gbps,
        )


# ---------------------------------------------------------------------------
# Catalogs
# ---------------------------------------------------------------------------

#: The 9 regions of the paper's scaling experiment (footnote 5), with standard
#: storage prices ($/GB/month) circa Sept 2023 (paper footnote 2).
_REGIONS = [
    Region("aws:us-east-1", 0.023),
    Region("aws:us-west-2", 0.023),
    Region("aws:eu-west-1", 0.023),
    Region("azure:eastus", 0.018),
    Region("azure:westus", 0.018),
    Region("azure:westeurope", 0.0196),
    Region("gcp:us-east1", 0.020),
    Region("gcp:us-west1", 0.020),
    Region("gcp:europe-west1", 0.020),
]

#: Egress overrides ($/GB).  Intra-cloud US pairs are cheap; transatlantic and
#: cross-cloud edges are 2-10x more, reproducing the paper's 15x/19x spreads.
_EGRESS_OVERRIDES: Dict[Tuple[str, str], float] = {}


def _o(src: str, dst: str, price: float) -> None:
    _EGRESS_OVERRIDES[(src, dst)] = price
    _EGRESS_OVERRIDES[(dst, src)] = price


_o("aws:us-east-1", "aws:us-west-2", 0.02)
_o("aws:us-east-1", "aws:eu-west-1", 0.02)
_o("aws:us-west-2", "aws:eu-west-1", 0.02)
_o("azure:eastus", "azure:westus", 0.02)
_o("azure:eastus", "azure:westeurope", 0.0875)
_o("azure:westus", "azure:westeurope", 0.0875)
_o("gcp:us-east1", "gcp:us-west1", 0.01)
_o("gcp:us-east1", "gcp:europe-west1", 0.05)
_o("gcp:us-west1", "gcp:europe-west1", 0.05)
# Cross-cloud edges: AWS egress to internet 0.09, GCP 0.12 (to non-GCP), Azure 0.0875.
for _src, _p in (("aws", 0.09), ("azure", 0.0875), ("gcp", 0.12)):
    for _a in [r.name for r in _REGIONS if r.provider == _src]:
        for _b in [r.name for r in _REGIONS if r.provider != _src]:
            _EGRESS_OVERRIDES[(_a, _b)] = _p


def default_catalog() -> CostModel:
    """The paper's 9-region, 3-cloud catalog."""
    return CostModel(list(_REGIONS), dict(_EGRESS_OVERRIDES))


def paper_2region_catalog() -> CostModel:
    """§3.1.1 worked example: aws:us-east-1 (base) and aws:us-west-1 (cache).

    Storage $0.026/GB/month at the cache, $0.02/GB egress on the edge, so
    T_even ~ 0.77 months -- asserted in tests.
    """
    regions = [Region("aws:us-east-1", 0.023), Region("aws:us-west-1", 0.026)]
    eg = {
        ("aws:us-east-1", "aws:us-west-1"): 0.02,
        ("aws:us-west-1", "aws:us-east-1"): 0.02,
    }
    return CostModel(regions, eg)


def tpu_tier_catalog() -> CostModel:
    """TPU-serving tier adaptation.

    Nodes are memory tiers, not cloud regions.  "Storage price" is the
    opportunity cost of occupying a GB of the tier for a month, derived from
    on-demand TPU v5e pricing (~$1.2/chip-hour, 16 GB HBM => ~$54/GB/month);
    host DRAM amortized server cost ~$1.3/GB/month; the object-store tier uses
    cloud storage pricing.  "Egress price" is the $-equivalent of transfer time
    at tier bandwidth (PCIe ~25 GB/s host<->HBM, ~2 GB/s store<->host),
    valuing chip time at the same $1.2/hour.  T_even then lands in *seconds*
    for HBM (evict KV blocks not re-used within seconds) and *hours* for host
    DRAM -- which is exactly the behaviour a KV/prefix-cache tier wants.
    """
    regions = [
        Region("tier:hbm", 54.0, first_byte_ms=0.001, intra_gbps=819 * 8),
        Region("tier:host", 0.11, first_byte_ms=0.01, intra_gbps=200.0),
        Region("tier:store", 0.023, first_byte_ms=25.0, intra_gbps=16.0),
    ]
    # $/GB equivalents of transfer time (value of stalled chip time).
    eg = {
        ("tier:hbm", "tier:host"): 1.6e-5,
        ("tier:host", "tier:hbm"): 1.6e-5,     # PCIe, ~0.04 s/GB at $1.2/h
        ("tier:host", "tier:store"): 2.0e-4,
        ("tier:store", "tier:host"): 2.0e-4,   # ~0.5 s/GB
        ("tier:hbm", "tier:store"): 2.2e-4,
        ("tier:store", "tier:hbm"): 2.2e-4,
    }
    return CostModel(regions, eg)


def pick_regions(n: int, catalog: CostModel | None = None) -> "CostModel":
    """The paper's 3/6/9-region experiment subsets (footnotes 3-5)."""
    cat = catalog or default_catalog()
    order3 = ["aws:us-east-1", "azure:eastus", "gcp:us-east1"]
    order6 = order3 + ["aws:us-west-2", "azure:westus", "gcp:us-west1"]
    order9 = order6 + ["aws:eu-west-1", "azure:westeurope", "gcp:europe-west1"]
    table = {3: order3, 6: order6, 9: order9}
    if n not in table:
        raise ValueError(f"n must be one of {tuple(table)}, got {n}")
    return cat.subset(table[n])
