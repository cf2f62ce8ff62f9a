"""Parameterized synthetic workload generator (beyond the five IBM profiles).

The PyTorch port's copy of :mod:`repro.core.workloads`.  Traces are drawn
with numpy's seeded ``default_rng`` exactly as the reference draws them: a
torch generator would draw other traces, and no golden fixture could match.

:mod:`repro_torch.core.traces` reproduces the paper's Table-2 trace *profiles*;
this module generates *structured* workloads that stress specific policy
behaviours far beyond those two seed shapes:

  ==============  ==========================================================
  zipfian         Zipf-skewed popularity, per-object reader affinity,
                  occasional overwrites, HEAD traffic, terminal deletes.
  hotspot_shift   the hot set (and the region reading it) is re-drawn every
                  phase -- punishes policies that overfit early statistics.
  diurnal         three regions wake and sleep on offset day cycles; the
                  "awake" region issues the reads (multi-region §6.1.3 E-mix
                  flavour, but time-correlated).
  write_heavy     high overwrite rate from a writer region with remote
                  readers -- exercises LWW stale-replica drops and §4.4
                  sync-to-base.
  scan_backup     daily sequential full-bucket sweep (plus LISTs) from a
                  backup region over a light random-read floor -- the
                  classic one-pass scan that defeats naive caching.
  ==============  ==========================================================

Every generator returns a :class:`~repro_torch.core.traces.Trace`, so the output
replays through both the :class:`~repro_torch.core.simulator.Simulator` and the
live :class:`~repro.core.virtual_store.VirtualStore` (see
:mod:`repro.core.replay`).  Generated traces maintain the replay invariants:
strictly increasing timestamps, first event per object is its PUT, and no
object is accessed after its DELETE.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .engine import OutageSchedule, OutageWindow
from .traces import (
    DAY, EVENT_DTYPE, OP_DELETE, OP_GET, OP_HEAD, OP_LIST, OP_PUT, Trace,
)

KB = 1024


def _rng(name: str, seed: int) -> np.random.Generator:
    return np.random.default_rng(seed ^ (zlib.crc32(name.encode()) % (2**31)))


def _sizes(rng: np.random.Generator, n: int,
           size_range: Tuple[int, int]) -> np.ndarray:
    lo, hi = size_range
    u = rng.random(n)
    return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))).astype(np.int64)


def _zipf_weights(n: int, alpha: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** alpha
    return w / w.sum()


def _finalize(name: str, rows: List[Tuple], regions: Sequence[str],
              n_buckets: int) -> Trace:
    """Sort, strictify timestamps, and pack rows into a Trace.

    Rows are (t, op, obj, size, region_idx) -- the bucket is derived from the
    object id (LIST rows carry obj = the bucket index directly, size 0).
    """
    rows.sort(key=lambda r: r[0])
    n = len(rows)
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    t_prev = -1.0
    for i, (t, op, obj, size, region) in enumerate(rows):
        # Strictly increasing event times: equal stamps break the "PUT
        # strictly precedes first GET" replay invariant under re-sorting.
        t = t if t > t_prev else t_prev + 1e-3
        t_prev = t
        bucket = obj % n_buckets if op != OP_LIST else obj
        ev[i] = (t, op, obj if op != OP_LIST else 0, size, region, bucket)
    buckets = tuple(f"bucket-{i}" for i in range(n_buckets))
    return Trace(name, ev, tuple(regions), buckets)


def _append_deletes(rng: np.random.Generator, rows: List[Tuple],
                    delete_frac: float, n_objects: int) -> None:
    """Terminal deletes: each chosen object is deleted strictly after its
    last access, so neither plane ever routes a request at a dead key."""
    if delete_frac <= 0 or not rows:
        return
    last: Dict[int, Tuple[float, int]] = {}
    for (t, op, obj, _s, region) in rows:
        # max-timestamp, not last-appended: rows may arrive out of time order
        if op != OP_LIST and (obj not in last or t >= last[obj][0]):
            last[obj] = (t, region)
    victims = rng.choice(n_objects, size=max(1, int(delete_frac * n_objects)),
                         replace=False)
    for obj in victims:
        if int(obj) in last:
            t, region = last[int(obj)]
            rows.append((t + 60.0 + rng.random() * 3600.0, OP_DELETE,
                         int(obj), 0, region))


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def zipfian(
    regions: Sequence[str],
    n_objects: int = 150,
    n_requests: int = 2000,
    alpha: float = 1.1,
    put_frac: float = 0.06,
    head_frac: float = 0.05,
    delete_frac: float = 0.05,
    affinity: float = 0.7,
    duration: float = 10 * DAY,
    size_range: Tuple[int, int] = (4 * KB, 64 * KB),
    n_buckets: int = 2,
    seed: int = 0,
) -> Trace:
    """Zipf-skewed key popularity with per-object reader affinity."""
    rng = _rng("zipfian", seed)
    n_r = len(regions)
    sizes = _sizes(rng, n_objects, size_range)
    home = rng.integers(0, n_r, size=n_objects)
    reader = (home + 1 + rng.integers(0, max(n_r - 1, 1), size=n_objects)) % n_r
    pop = _zipf_weights(n_objects, alpha)
    rank = rng.permutation(n_objects)          # popularity order != id order

    rows: List[Tuple] = []
    put_t = rng.random(n_objects) * 0.2 * duration
    for o in range(n_objects):
        rows.append((put_t[o], OP_PUT, o, int(sizes[o]), int(home[o])))
    req_t = np.sort(0.2 * duration + rng.random(n_requests) * 0.8 * duration)
    objs = rank[rng.choice(n_objects, size=n_requests, p=pop)]
    u = rng.random(n_requests)
    for i in range(n_requests):
        o = int(objs[i])
        if u[i] < put_frac:
            rows.append((req_t[i], OP_PUT, o, int(sizes[o]), int(home[o])))
        else:
            r = (int(reader[o]) if rng.random() < affinity
                 else int(rng.integers(0, n_r)))
            op = OP_HEAD if u[i] < put_frac + head_frac else OP_GET
            rows.append((req_t[i], op, o, int(sizes[o]), r))
    for d in range(1, int(duration / DAY)):
        rows.append((d * DAY + 17.0, OP_LIST, int(rng.integers(0, n_buckets)),
                     0, int(rng.integers(0, n_r))))
    _append_deletes(rng, rows, delete_frac, n_objects)
    return _finalize("wl/zipfian", rows, regions, n_buckets)


def hotspot_shift(
    regions: Sequence[str],
    n_objects: int = 150,
    n_requests: int = 2000,
    n_phases: int = 4,
    hot_frac: float = 0.08,
    hot_share: float = 0.9,
    duration: float = 12 * DAY,
    size_range: Tuple[int, int] = (4 * KB, 64 * KB),
    n_buckets: int = 2,
    seed: int = 0,
) -> Trace:
    """The hot object set -- and the region hammering it -- moves each phase."""
    rng = _rng("hotspot", seed)
    n_r = len(regions)
    sizes = _sizes(rng, n_objects, size_range)
    home = rng.integers(0, n_r, size=n_objects)

    rows: List[Tuple] = []
    put_t = rng.random(n_objects) * 0.1 * duration
    for o in range(n_objects):
        rows.append((put_t[o], OP_PUT, o, int(sizes[o]), int(home[o])))

    phase_len = 0.9 * duration / n_phases
    per_phase = n_requests // n_phases
    n_hot = max(1, int(hot_frac * n_objects))
    for p in range(n_phases):
        t0 = 0.1 * duration + p * phase_len
        hot = rng.choice(n_objects, size=n_hot, replace=False)
        hot_region = int((p + rng.integers(0, n_r)) % n_r)
        ts = np.sort(t0 + rng.random(per_phase) * phase_len)
        for i in range(per_phase):
            if rng.random() < hot_share:
                o = int(hot[rng.integers(0, n_hot)])
                r = hot_region
            else:
                o = int(rng.integers(0, n_objects))
                r = int(rng.integers(0, n_r))
            rows.append((float(ts[i]), OP_GET, o, int(sizes[o]), r))
    return _finalize("wl/hotspot_shift", rows, regions, n_buckets)


def diurnal(
    regions: Sequence[str],
    n_objects: int = 120,
    n_requests: int = 2000,
    duration: float = 7 * DAY,
    size_range: Tuple[int, int] = (4 * KB, 64 * KB),
    n_buckets: int = 2,
    seed: int = 0,
) -> Trace:
    """Each region's read traffic follows an offset day-cycle (§6.1.3-style
    multi-region load, but time-correlated: the awake region reads)."""
    rng = _rng("diurnal", seed)
    n_r = len(regions)
    sizes = _sizes(rng, n_objects, size_range)
    home = rng.integers(0, n_r, size=n_objects)

    rows: List[Tuple] = []
    put_t = rng.random(n_objects) * 0.15 * duration
    for o in range(n_objects):
        rows.append((put_t[o], OP_PUT, o, int(sizes[o]), int(home[o])))

    ts = np.sort(0.15 * duration + rng.random(n_requests) * 0.85 * duration)
    phases = np.arange(n_r) * (2.0 * math.pi / max(n_r, 1))
    for t in ts:
        w = np.maximum(np.sin(2.0 * math.pi * (t / DAY) + phases), 0.05)
        r = int(rng.choice(n_r, p=w / w.sum()))
        o = int(rng.integers(0, n_objects))
        rows.append((float(t), OP_GET, o, int(sizes[o]), r))
    return _finalize("wl/diurnal", rows, regions, n_buckets)


def write_heavy(
    regions: Sequence[str],
    n_objects: int = 100,
    n_requests: int = 1800,
    put_frac: float = 0.45,
    cross_region_put_frac: float = 0.3,
    delete_frac: float = 0.08,
    duration: float = 8 * DAY,
    size_range: Tuple[int, int] = (4 * KB, 32 * KB),
    n_buckets: int = 2,
    seed: int = 0,
) -> Trace:
    """Frequent overwrites (some cross-region) with remote readers --
    last-writer-wins drops and §4.4 sync-to-base dominate."""
    rng = _rng("write_heavy", seed)
    n_r = len(regions)
    sizes = _sizes(rng, n_objects, size_range)
    writer = rng.integers(0, n_r, size=n_objects)

    rows: List[Tuple] = []
    put_t = rng.random(n_objects) * 0.1 * duration
    for o in range(n_objects):
        rows.append((put_t[o], OP_PUT, o, int(sizes[o]), int(writer[o])))
    ts = np.sort(0.1 * duration + rng.random(n_requests) * 0.9 * duration)
    u = rng.random(n_requests)
    for i, t in enumerate(ts):
        o = int(rng.integers(0, n_objects))
        if u[i] < put_frac:
            r = int(writer[o])
            if rng.random() < cross_region_put_frac:
                r = int((r + 1 + rng.integers(0, max(n_r - 1, 1))) % n_r)
            rows.append((float(t), OP_PUT, o, int(sizes[o]), r))
        else:
            r = int((writer[o] + 1 + rng.integers(0, max(n_r - 1, 1))) % n_r)
            rows.append((float(t), OP_GET, o, int(sizes[o]), r))
    _append_deletes(rng, rows, delete_frac, n_objects)
    return _finalize("wl/write_heavy", rows, regions, n_buckets)


def scan_backup(
    regions: Sequence[str],
    n_objects: int = 120,
    n_random_reads: int = 800,
    duration: float = 7 * DAY,
    scan_window: float = 2 * 3600.0,
    size_range: Tuple[int, int] = (4 * KB, 32 * KB),
    n_buckets: int = 2,
    seed: int = 0,
) -> Trace:
    """A daily sequential sweep of every key from a backup region (preceded
    by per-bucket LISTs) over a light random-read floor -- the one-pass scan
    pattern that defeats naive replicate-on-read caching."""
    rng = _rng("scan_backup", seed)
    n_r = len(regions)
    sizes = _sizes(rng, n_objects, size_range)
    home = rng.integers(0, n_r, size=n_objects)
    backup = int(rng.integers(0, n_r))

    rows: List[Tuple] = []
    put_t = rng.random(n_objects) * 0.5 * DAY
    for o in range(n_objects):
        rows.append((put_t[o], OP_PUT, o, int(sizes[o]), int(home[o])))
    # daily sweeps, each preceded by a LIST of every bucket
    for d in range(1, int(duration / DAY)):
        t0 = d * DAY + 3600.0
        for b in range(n_buckets):
            rows.append((t0 - 60.0 + b, OP_LIST, b, 0, backup))
        offs = np.sort(rng.random(n_objects)) * scan_window
        for o in range(n_objects):
            rows.append((t0 + float(offs[o]), OP_GET, o, int(sizes[o]), backup))
    # random-read floor from the non-backup regions
    ts = np.sort(0.5 * DAY + rng.random(n_random_reads) * (duration - 0.5 * DAY))
    for t in ts:
        o = int(rng.integers(0, n_objects))
        r = int(rng.integers(0, n_r))
        rows.append((float(t), OP_GET, o, int(sizes[o]), r))
    return _finalize("wl/scan_backup", rows, regions, n_buckets)


WORKLOADS = {
    "zipfian": zipfian,
    "hotspot_shift": hotspot_shift,
    "diurnal": diurnal,
    "write_heavy": write_heavy,
    "scan_backup": scan_backup,
}

WORKLOAD_NAMES = tuple(WORKLOADS)

#: Size tiers: parameter overrides per workload.  The golden replay matrix
#: runs the (default) small tier; the "large" tier (>= 100k events,
#: >= 10k objects) is the replay-throughput benchmark scale -- the event
#: spine keeps the live plane O(expired) per event there, where the old
#: per-event eviction scan was O(objects) (see benchmarks/run.py).
WORKLOAD_TIERS: Dict[str, Dict[str, dict]] = {
    "large": {
        "zipfian": dict(n_objects=10_000, n_requests=100_000, n_buckets=8,
                        duration=30 * DAY),
        "hotspot_shift": dict(n_objects=10_000, n_requests=100_000,
                              n_phases=8, n_buckets=8, duration=30 * DAY),
        "diurnal": dict(n_objects=10_000, n_requests=100_000, n_buckets=8,
                        duration=30 * DAY),
        "write_heavy": dict(n_objects=10_000, n_requests=100_000,
                            n_buckets=8, duration=30 * DAY),
        "scan_backup": dict(n_objects=10_000, n_random_reads=40_000,
                            n_buckets=8, duration=14 * DAY),
    },
    # The §6.7.3-scale tier: >= 1M events over >= 100k objects.  Replays on
    # BOTH planes with zero divergence (the env-gated xlarge differential in
    # tests/test_replay_differential.py); BENCH_9.json carries its measured
    # events/sec.  The batched spine (engine.iter_batches) is what makes a
    # 1M-event live replay tractable.
    "xlarge": {
        "zipfian": dict(n_objects=100_000, n_requests=1_000_000,
                        n_buckets=16, duration=90 * DAY),
        "hotspot_shift": dict(n_objects=100_000, n_requests=1_000_000,
                              n_phases=12, n_buckets=16, duration=90 * DAY),
        "diurnal": dict(n_objects=100_000, n_requests=1_000_000,
                        n_buckets=16, duration=90 * DAY),
        "write_heavy": dict(n_objects=100_000, n_requests=1_000_000,
                            n_buckets=16, duration=90 * DAY),
        "scan_backup": dict(n_objects=100_000, n_random_reads=400_000,
                            n_buckets=16, duration=30 * DAY),
    },
}


# ---------------------------------------------------------------------------
# §6.4 failure plane: seeded outage-schedule generation
# ---------------------------------------------------------------------------

#: Named outage shapes for the chaos golden matrix (see repro.core.replay):
#:
#:   single    one region dark for one long window mid-trace -- the classic
#:             "us-east-1 is having a day" scenario;
#:   rolling   every region goes dark once, in turn, non-overlapping --
#:             exercises failover *and* recovery (deferred syncs, lazy
#:             collection) for each region;
#:   flaky     one region blinks through many short windows -- stresses the
#:             down/up transition machinery far more than the steady state.
#:
#: All profiles keep at least one region live at every instant: a full
#: blackout 503s PUTs, after which the planes legitimately report the
#: downstream missing-key errors differently (the invalid-trace contract).
OUTAGE_PROFILE_NAMES = ("single", "rolling", "flaky")


def make_outage_schedule(
    profile: str,
    regions: Sequence[str],
    duration: float,
    seed: int = 0,
) -> OutageSchedule:
    """Compile a named outage ``profile`` into a seeded, replay-safe
    :class:`~repro_torch.core.engine.OutageSchedule` over ``regions`` and a trace
    of ``duration`` seconds.  Deterministic in (profile, regions, duration,
    seed) -- the golden outage fixtures pin its output."""
    rng = _rng(f"outage/{profile}", seed)
    n_r = len(regions)
    windows = []
    if profile == "single":
        r = int(rng.integers(0, n_r))
        start = (0.35 + 0.1 * rng.random()) * duration
        windows.append(OutageWindow(regions[r], start,
                                    start + 0.15 * duration))
    elif profile == "rolling":
        # one slot per region inside the middle 70% of the trace, with
        # gaps between slots so recoveries complete before the next hit
        slot = 0.7 * duration / max(n_r, 1)
        order = rng.permutation(n_r)
        for i, r in enumerate(order):
            start = 0.15 * duration + i * slot + 0.1 * slot * rng.random()
            windows.append(OutageWindow(regions[int(r)], start,
                                        start + 0.55 * slot))
    elif profile == "flaky":
        r = int(rng.integers(0, n_r))
        starts = np.sort(rng.random(6)) * 0.8 * duration + 0.1 * duration
        for s in starts:
            windows.append(OutageWindow(regions[r], float(s),
                                        float(s) + 0.02 * duration))
    else:
        raise KeyError(f"unknown outage profile {profile!r}; have "
                       f"{OUTAGE_PROFILE_NAMES}")
    sched = OutageSchedule(windows)
    assert sched.max_concurrent_down(regions) < max(n_r, 1), \
        "outage profile must keep >= 1 region live"
    return sched


def make_workload(name: str, regions: Sequence[str], seed: int = 0,
                  tier: Optional[str] = None, **kw) -> Trace:
    """Generate workload ``name``.  ``tier`` selects a named parameter set
    from :data:`WORKLOAD_TIERS` (e.g. ``"large"``); explicit keyword
    arguments override the tier's parameters."""
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {WORKLOAD_NAMES}")
    params: dict = {}
    if tier is not None:
        if tier not in WORKLOAD_TIERS:
            raise KeyError(f"unknown tier {tier!r}; have "
                           f"{tuple(WORKLOAD_TIERS)}")
        params.update(WORKLOAD_TIERS[tier].get(name, {}))
    params.update(kw)
    return WORKLOADS[name](regions, seed=seed, **params)


def random_outage_schedule(
    regions: Sequence[str],
    duration: float,
    seed: int = 0,
    max_windows: int = 4,
    max_frac: float = 0.3,
) -> OutageSchedule:
    """A fuzzing schedule: up to ``max_windows`` random windows (each up to
    ``max_frac`` of the trace) across random regions, thinned until no
    instant has every region down (the differential-replay invariant)."""
    rng = _rng("outage/random", seed)
    windows = []
    for _ in range(int(rng.integers(0, max_windows + 1))):
        r = regions[int(rng.integers(0, len(regions)))]
        start = rng.random() * duration
        windows.append(OutageWindow(r, float(start),
                                    float(start + rng.random() * max_frac
                                          * duration)))
    while windows:
        sched = OutageSchedule(windows)
        if sched.max_concurrent_down(regions) < len(regions):
            return sched
        windows.pop(int(rng.integers(0, len(windows))))
    return OutageSchedule([])
