"""Synthetic IBM/SNIA-style object-store traces (paper §6.1).

The real SNIA IBM traces (IOTTA set 36305) are not redistributable in this
offline environment, so we generate *synthetic* traces that reproduce the five
representative profiles' published characteristics (paper Table 2 + Fig. 4):

  ======  =================================================================
  T15     80% small / 20% medium; 48% one-hit, 52% cold; ~3 GETs avg;
          write-heavy (43% PUT); inter-arrival within a day; no accesses in
          the final two months.
  T29     44% tiny / 56% small; 98% cold; ~3 GETs; 30% PUT; recency spread
          one day .. two months; the largest request count.
  T65     31% tiny / 34% small / 34% medium / 0.03% large; 67% hot + 22%
          warm; ~93 GETs avg; 99% GET; bursty (2-8 GETs within 10 min).
  T78     ~98% small; 51% warm; 60% of GETs burst into the last two months;
          read-heavy.
  T79     40% small / 60% medium / 0.35% large (avg ~48 MB); 17% one-hit,
          majority cold; 89% GET; GET tail ~4.1 months.
  ======  =================================================================

Each day of the original week-long traces is expanded to a month (§6.1.1:
"we expand a day in each trace to a month ... to three months for multi-cloud")
by generating directly on a multi-month timeline.

Multi-region workload synthesis (§6.1.3):
  A uniform     -- every request lands on a uniformly random region;
  B region-aware-- per-object dedicated PUT region and (distinct) GET region;
  C aggregation -- PUTs spread across regions, all GETs from one central region;
  D replication -- dedicated PUT region per object, GETs spread across others;
  E mix         -- blend of A-D (used for the end-to-end run, §6.1.3 step 3).
The classic 2-region base/cache setup (§3.1) PUTs at the base and GETs at the
cache region.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np

from .api import (
    DeleteObjectRequest, GetRequest, HeadRequest, ListRequest, PutRequest,
)
from .engine import OutageSchedule

#: Trace event op codes (the ``op`` column of :data:`EVENT_DTYPE`).
OP_PUT, OP_GET, OP_DELETE, OP_HEAD, OP_LIST = 0, 1, 2, 3, 4

DAY = 24 * 3600.0
MONTH = 30 * DAY

EVENT_DTYPE = np.dtype(
    [
        ("t", np.float64),
        ("op", np.uint8),
        ("obj", np.int64),
        ("size", np.int64),
        ("region", np.int32),
        ("bucket", np.int32),
    ]
)


@dataclasses.dataclass
class Trace:
    name: str
    events: np.ndarray                   # EVENT_DTYPE, sorted by t
    regions: Tuple[str, ...]
    buckets: Tuple[str, ...]
    #: Optional §6.4 failure plane: an
    #: :class:`~repro_torch.core.engine.OutageSchedule` of (region, down, up)
    #: windows.  Both replay planes compile it into the shared event
    #: spine's REGION_DOWN/REGION_UP stream, so a trace *carries* its chaos
    #: scenario the same way it carries its requests.
    outages: Optional["OutageSchedule"] = None

    def with_outages(self, outages: "OutageSchedule") -> "Trace":
        """A copy of this trace with the outage schedule attached (events
        are shared, not copied)."""
        return dataclasses.replace(self, outages=outages)

    @property
    def duration(self) -> float:
        return float(self.events["t"][-1]) if len(self.events) else 0.0

    def iter_requests(
        self,
    ) -> Iterator[Union[PutRequest, GetRequest, DeleteObjectRequest,
                        HeadRequest, ListRequest]]:
        """Replay the trace as the typed :mod:`repro_torch.core.api` request
        objects every :class:`~repro_torch.core.api.ObjectStoreAPI` implementation
        consumes -- the simulator and the live store share one op language.
        Object ids become string keys; event time rides in ``at``.  HEAD and
        LIST events carry the issuing region for per-request op charges."""
        ev = self.events
        for i in range(len(ev)):
            t = float(ev["t"][i])
            op = int(ev["op"][i])
            region = self.regions[int(ev["region"][i])]
            bucket = self.buckets[int(ev["bucket"][i])]
            if op == OP_LIST:
                yield ListRequest(bucket, region=region, at=t)
                continue
            key = str(int(ev["obj"][i]))
            if op == OP_PUT:
                yield PutRequest(bucket, key, region,
                                 size=int(ev["size"][i]), at=t)
            elif op == OP_GET:
                yield GetRequest(bucket, key, region, at=t)
            elif op == OP_HEAD:
                yield HeadRequest(bucket, key, region=region, at=t)
            else:
                yield DeleteObjectRequest(bucket, key, region, at=t)

    def stats(self) -> Dict[str, float]:
        ev = self.events
        gets = ev["op"] == OP_GET
        return {
            "events": len(ev),
            "gets": int(gets.sum()),
            "puts": int((ev["op"] == OP_PUT).sum()),
            "objects": int(len(np.unique(ev["obj"]))),
            "bytes_put": float(ev["size"][ev["op"] == OP_PUT].sum()),
            "months": self.duration / MONTH,
        }


# ---------------------------------------------------------------------------
# Per-trace profiles (Table 2)
# ---------------------------------------------------------------------------

KB, MB, GB_ = 1024, 1024**2, 1024**3

#: (size-class weights [tiny, small, medium, large],
#:  read-frequency weights [one-hit, cold, warm, hot, superhot],
#:  put_fraction, burstiness, recency profile, active-window)
PROFILES: Dict[str, Dict] = {
    "T15": dict(
        sizes=[0.0, 0.80, 0.20, 0.0],
        freq=[0.48, 0.52, 0.0, 0.0, 0.0],
        put_frac=0.43,
        burst_p=0.05,
        gap_scale=0.6 * DAY,
        gap_sigma=1.2,
        active=(0.0, 0.60),          # no accesses in the last 2 of 5 months
        months=5.0,
        n_objects=1400,
    ),
    "T29": dict(
        sizes=[0.44, 0.56, 0.0, 0.0],
        freq=[0.02, 0.98, 0.0, 0.0, 0.0],
        put_frac=0.30,
        burst_p=0.05,
        gap_scale=20.0 * DAY,
        gap_sigma=1.4,
        active=(0.0, 1.0),
        months=5.0,
        n_objects=2600,
    ),
    "T65": dict(
        sizes=[0.31, 0.34, 0.3497, 0.0003],
        freq=[0.02, 0.09, 0.22, 0.669, 0.001],
        put_frac=0.01,
        burst_p=0.45,
        gap_scale=1.3 * DAY,
        gap_sigma=1.1,
        active=(0.0, 1.0),
        months=5.0,
        n_objects=260,
    ),
    "T78": dict(
        sizes=[0.01, 0.98, 0.01, 0.0],
        freq=[0.10, 0.30, 0.51, 0.088, 0.002],
        put_frac=0.10,
        burst_p=0.30,
        gap_scale=2.6 * DAY,
        gap_sigma=1.2,
        active=(0.55, 1.0),          # 60% of GETs in the last two months
        months=5.0,
        n_objects=700,
    ),
    "T79": dict(
        sizes=[0.0, 0.3965, 0.60, 0.0035],
        freq=[0.17, 0.55, 0.22, 0.06, 0.0],
        put_frac=0.11,
        burst_p=0.20,
        gap_scale=8.3 * DAY,
        gap_sigma=1.3,
        active=(0.0, 1.0),
        months=5.0,
        n_objects=420,
    ),
}

TRACE_NAMES = tuple(PROFILES)

_SIZE_RANGES = [  # tiny, small, medium, large  (log-uniform within range)
    (128, 1 * KB),
    (1 * KB, 1 * MB),
    (1 * MB, 1 * GB_),
    (1 * GB_, 4 * GB_),
]
_FREQ_RANGES = [(1, 1), (2, 10), (10, 100), (100, 1000), (1000, 3000)]


def _sample_sizes(rng: np.random.Generator, weights, n: int) -> np.ndarray:
    cls = rng.choice(4, size=n, p=np.asarray(weights) / np.sum(weights))
    lo = np.asarray([_SIZE_RANGES[c][0] for c in cls], dtype=np.float64)
    hi = np.asarray([_SIZE_RANGES[c][1] for c in cls], dtype=np.float64)
    u = rng.random(n)
    return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))).astype(np.int64)


def _sample_get_counts(rng: np.random.Generator, weights, n: int) -> np.ndarray:
    cls = rng.choice(5, size=n, p=np.asarray(weights) / np.sum(weights))
    lo = np.asarray([_FREQ_RANGES[c][0] for c in cls], dtype=np.float64)
    hi = np.asarray([_FREQ_RANGES[c][1] for c in cls], dtype=np.float64)
    u = rng.random(n)
    return np.maximum(
        np.exp(np.log(lo) + u * (np.log(np.maximum(hi, lo + 1e-9)) - np.log(lo))), 1.0
    ).astype(np.int64)


def _object_get_times(
    rng: np.random.Generator,
    put_t: float,
    n_gets: int,
    p: Dict,
    horizon: float,
) -> np.ndarray:
    """GET timestamps: lognormal gaps + occasional 2-8-GET bursts within 10 min
    (the §3.2.3 bursty behaviour that defeats per-object/Poisson methods)."""
    times = []
    t = put_t
    lo, hi = p["active"]
    t0, t1 = lo * horizon, hi * horizon
    remaining = n_gets
    while remaining > 0:
        gap = rng.lognormal(np.log(p["gap_scale"]), p["gap_sigma"])
        t = t + gap
        if t > t1:
            break
        if t < t0:
            t = t0 + rng.random() * min(p["gap_scale"], t1 - t0)
        if rng.random() < p["burst_p"] and remaining > 1:
            k = int(min(rng.integers(2, 9), remaining))
            burst = np.sort(t + rng.random(k) * 600.0)     # within 10 minutes
            times.extend(burst.tolist())
            t = float(burst[-1])
            remaining -= k
        else:
            times.append(t)
            remaining -= 1
    return np.asarray(times, dtype=np.float64)


def generate_trace(
    name: str,
    seed: int = 0,
    n_objects: Optional[int] = None,
    months: Optional[float] = None,
    n_buckets: int = 4,
) -> Trace:
    """Single-region logical trace (region assignment happens later)."""
    if name not in PROFILES:
        raise KeyError(f"unknown trace {name!r}; have {TRACE_NAMES}")
    p = dict(PROFILES[name])
    n_obj = n_objects or p["n_objects"]
    horizon = (months or p["months"]) * MONTH
    # zlib.crc32, NOT hash(): str hash is randomized per process and would
    # make traces (and every benchmark number) non-reproducible.
    import zlib
    rng = np.random.default_rng(seed ^ (zlib.crc32(name.encode()) % (2**31)))

    sizes = _sample_sizes(rng, p["sizes"], n_obj)
    counts = _sample_get_counts(rng, p["freq"], n_obj)
    # Temper GET counts by the PUT fraction so op mix lands near Table 2.
    put_times = rng.random(n_obj) ** 1.5 * horizon * 0.55

    rows = []
    for oid in range(n_obj):
        rows.append((put_times[oid], OP_PUT, oid, sizes[oid]))
        gts = _object_get_times(rng, put_times[oid], int(counts[oid]), p, horizon)
        for t in gts:
            rows.append((t, OP_GET, oid, sizes[oid]))
        # Occasional overwrite for write-heavy traces (new version, §2.3).
        if p["put_frac"] > 0.25 and rng.random() < 0.5:
            t_over = put_times[oid] + rng.random() * (horizon - put_times[oid])
            rows.append((t_over, OP_PUT, oid, sizes[oid]))

    rows.sort(key=lambda r: r[0])
    ev = np.zeros(len(rows), dtype=EVENT_DTYPE)
    ev["t"] = [r[0] for r in rows]
    ev["op"] = [r[1] for r in rows]
    ev["obj"] = [r[2] for r in rows]
    ev["size"] = [r[3] for r in rows]
    ev["bucket"] = ev["obj"] % n_buckets
    buckets = tuple(f"bucket-{i}" for i in range(n_buckets))
    return Trace(name, ev, ("local",), buckets)


# ---------------------------------------------------------------------------
# Region assignment (§6.1.3)
# ---------------------------------------------------------------------------

def assign_two_region(trace: Trace, base: str, cache: str) -> Trace:
    """§3.1 base/cache: PUTs at the base region, GETs at the cache region."""
    ev = trace.events.copy()
    ev["region"] = np.where(ev["op"] == OP_PUT, 0, 1)
    return Trace(f"{trace.name}/2region", ev, (base, cache), trace.buckets)


def assign_workload(
    trace: Trace,
    regions: Sequence[str],
    kind: str,
    seed: int = 0,
) -> Trace:
    """Types A-E of §6.1.3 over an arbitrary region list."""
    rng = np.random.default_rng(seed * 7919 + 13)
    ev = trace.events.copy()
    n_r = len(regions)
    objs = ev["obj"]
    n_obj = int(objs.max()) + 1 if len(objs) else 0
    kind = kind.upper()

    if kind == "A":          # uniform
        ev["region"] = rng.integers(0, n_r, size=len(ev))
    elif kind == "B":        # region-aware: dedicated PUT and GET region per object
        put_r = rng.integers(0, n_r, size=n_obj)
        get_r = (put_r + 1 + rng.integers(0, n_r - 1, size=n_obj)) % n_r
        is_put = ev["op"] != OP_GET
        ev["region"] = np.where(is_put, put_r[objs], get_r[objs])
    elif kind == "C":        # aggregation: PUT anywhere, GET from a central region
        central = int(rng.integers(0, n_r))
        ev["region"] = np.where(
            ev["op"] != OP_GET, rng.integers(0, n_r, size=len(ev)), central
        )
    elif kind == "D":        # replication: dedicated PUT region, GETs elsewhere
        put_r = rng.integers(0, n_r, size=n_obj)
        shift = 1 + rng.integers(0, n_r - 1, size=len(ev))
        ev["region"] = np.where(
            ev["op"] != OP_GET, put_r[objs], (put_r[objs] + shift) % n_r
        )
    elif kind == "E":        # mix for the end-to-end run
        per_obj_kind = rng.integers(0, 4, size=n_obj)
        sub = {}
        for k, letter in enumerate("ABCD"):
            sub[k] = assign_workload(trace, regions, letter, seed + k).events["region"]
        ev["region"] = np.select(
            [per_obj_kind[objs] == k for k in range(4)], [sub[k] for k in range(4)]
        )
    else:
        raise KeyError(f"unknown workload kind {kind!r}")
    return Trace(f"{trace.name}/{kind}", ev, tuple(regions), trace.buckets)


WORKLOAD_KINDS = ("A", "B", "C", "D")
