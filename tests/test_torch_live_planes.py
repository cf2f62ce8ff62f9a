"""The port's live plane against the reference, on seeded random inputs.

* Random small traces (and the same traces under random outage schedules)
  through both of the port's planes: zero divergence, and every decision,
  holder set, counter and dollar equal to the reference's differential on
  the same rows (the cases of ``tests/test_replay_differential.py`` and
  ``tests/test_chaos_failover.py``).
* The routing matrix under writes: ``route_chunk`` hints prepared for a
  chunk, then replicas written and dropped underneath them -- every hint
  still fresh equals the scalar ``choose_get_source`` on the new state, and
  exactly the rows written are stale (``tests/test_routing_matrix.py``);
  the whole-plane decision streams identical across routing engines.
* The §6.3 latency streams: sim and live identical, and equal to the
  reference's (``tests/test_latency_model.py``).
* The ``CostLedger``'s lifetime integration, bit-equal to the reference's,
  sequential and batched.
"""

import numpy as np
import pytest

from repro.core.api import ApiError as RApiError
from repro.core.api import choose_get_source as r_choose_get_source
from repro.core.costmodel import CostModel as RCostModel
from repro.core.costmodel import Region as RRegion
from repro.core.costmodel import pick_regions as r_pick_regions
from repro.core.ledger import CostLedger as RCostLedger
from repro.core.replay import replay_differential as r_replay_differential
from repro.core.replay import run_live_plane as r_run_live_plane
from repro.core.traces import Trace as RTrace
from repro.core.workloads import make_outage_schedule as r_make_outage_schedule
from repro.core.workloads import make_workload as r_make_workload
from repro.core.workloads import random_outage_schedule as r_random_outage
from repro_torch.core.api import ApiError, choose_get_source
from repro_torch.core.backends import InMemoryBackend
from repro_torch.core.costmodel import CostModel, Region, pick_regions
from repro_torch.core.ledger import CostLedger
from repro_torch.core.metadata import MetadataServer
from repro_torch.core.replay import (
    COST_RTOL, replay_differential, run_live_plane, run_sim_plane,
)
from repro_torch.core.routing import (
    ROUTE_INVALID, ROUTE_NO_KEY, ROUTE_OK, ROUTE_UNAVAILABLE, RoutingMatrix,
)
from repro_torch.core.traces import (
    EVENT_DTYPE, OP_DELETE, OP_GET, OP_HEAD, OP_PUT, Trace,
)
from repro_torch.core.virtual_store import VirtualStore
from repro_torch.core.workloads import (
    make_outage_schedule, make_workload, random_outage_schedule,
)

DAY = 24 * 3600.0
HOUR = 3600.0
INF = float("inf")
REGIONS = ("aws:a", "aws:b", "gcp:c")


def _tiny_cats():
    """Expensive storage / cheap egress => T_even ~43 min: TTL expiry,
    eviction and re-replication all happen inside short traces.  The same
    catalog in both packages."""
    out = []
    for cm, rg in ((CostModel, Region), (RCostModel, RRegion)):
        regions = [rg("aws:a", 10.0), rg("aws:b", 10.0), rg("gcp:c", 8.0)]
        eg = {(a.name, b.name): 0.01 for a in regions for b in regions
              if a.name != b.name}
        out.append(cm(regions, eg))
    return out


def _rows(steps):
    """Raw steps -> valid trace rows: first op per object is a PUT, nothing
    follows a DELETE, timestamps strictly increase."""
    rows, t, live = [], 0.0, {}
    for obj, op, region, gap in steps:
        t += gap
        if op == OP_PUT:
            live[obj] = True
            rows.append((t, OP_PUT, obj, 4096 + obj, region))
        elif op == OP_GET:
            if live.get(obj):
                rows.append((t, OP_GET, obj, 4096 + obj, region))
        elif live.get(obj):
            live[obj] = None
            rows.append((t, OP_DELETE, obj, 0, region))
    return rows


def _traces(rows, name="hyp"):
    """The same rows as a port Trace and a reference Trace."""
    ev = np.zeros(len(rows), dtype=EVENT_DTYPE)
    for i, row in enumerate(rows):
        ev[i] = (*row, 0)
    return (Trace(name, ev, REGIONS, ("bucket-0",)),
            RTrace(name, ev.copy(), REGIONS, ("bucket-0",)))


def _random_steps(rng):
    """Seeded steps, opening with a PUT so that no drawn trace is empty."""
    n = int(rng.integers(5, 40))
    return [(0, OP_PUT, 0, 60.0)] + [(int(rng.integers(0, 3)),
             [OP_PUT, OP_GET, OP_GET, OP_GET, OP_DELETE][int(rng.integers(0, 5))],
             int(rng.integers(0, 3)),
             60.0 + float(rng.random()) * 2 * DAY)
            for _ in range(n)]


def _agree(r, rr):
    """A port DiffReport: zero divergence, and equal to the reference's."""
    assert r.placement_mismatches == [], r.placement_mismatches[:3]
    assert r.holder_mismatches == [], r.holder_mismatches[:3]
    assert r.counter_diffs == {}, r.counter_diffs
    assert r.max_rel_cost_delta <= COST_RTOL
    assert r.to_json() == rr.to_json()


_PROP_POLICIES = ("t_even", "skystore", "ewma", "always_evict", "cgp")


@pytest.mark.parametrize("seed", range(12))
def test_random_traces_sim_and_live_agree(seed):
    rng = np.random.default_rng(seed * 9973 + 11)
    trace, r_trace = _traces(_rows(_random_steps(rng)))
    policy = _PROP_POLICIES[seed % len(_PROP_POLICIES)]
    mode = "FP" if seed % 3 == 0 else "FB"
    cat, r_cat = _tiny_cats()
    r = replay_differential(trace, cat, policy, mode=mode,
                            scan_interval=HOUR, device="cpu")
    rr = r_replay_differential(r_trace, r_cat, policy, mode=mode,
                               scan_interval=HOUR)
    _agree(r, rr)


_CHAOS_POLICIES = ("t_even", "skystore", "ewma", "always_evict", "cgp",
                   "always_store", "spanstore")


@pytest.mark.parametrize("seed", range(16))
def test_random_chaos_traces_sim_and_live_agree(seed):
    rng = np.random.default_rng(seed * 7717 + 3)
    trace, r_trace = _traces(_rows(_random_steps(rng)), "chaos")
    sched = random_outage_schedule(REGIONS, trace.duration, seed=seed * 31 + 1)
    r_sched = r_random_outage(REGIONS, trace.duration, seed=seed * 31 + 1)
    assert ([tuple(w.__dict__.values()) for w in sched.windows]
            == [tuple(w.__dict__.values()) for w in r_sched.windows])
    policy = _CHAOS_POLICIES[seed % len(_CHAOS_POLICIES)]
    mode = "FP" if seed % 3 == 0 else "FB"
    cat, r_cat = _tiny_cats()
    outage = "fuzz" if len(sched) else ""
    r = replay_differential(trace, cat, policy, mode=mode, scan_interval=HOUR,
                            outages=sched, outage=outage, device="cpu")
    rr = r_replay_differential(r_trace, r_cat, policy, mode=mode,
                               scan_interval=HOUR, outages=r_sched,
                               outage=outage)
    _agree(r, rr)


def test_invalid_trace_reports_divergence_instead_of_crashing():
    """A GET before its PUT: the sim skips it, the live plane 404s -- the
    driver reports a decision diff, as the reference's does."""
    rows = [(10.0, OP_GET, 5, 1024, 0), (20.0, OP_PUT, 1, 1024, 0),
            (30.0, OP_HEAD, 9, 0, 1)]
    trace, r_trace = _traces(rows, "bad")
    cat, r_cat = _tiny_cats()
    r = replay_differential(trace, cat, "t_even", device="cpu")
    rr = r_replay_differential(r_trace, r_cat, "t_even")
    assert not r.ok()
    assert any("error:NoSuchKey" in str(m) for m in r.placement_mismatches)
    assert r.placement_mismatches == rr.placement_mismatches


# ---------------------------------------------------------------------------
# Routing under writes
# ---------------------------------------------------------------------------

def _scalar(committed, dst, now, cost, unavailable=frozenset()):
    try:
        src, hit = choose_get_source(committed, dst, now, cost, unavailable)
        return src, hit, ROUTE_OK
    except ApiError as e:
        if e.code == "NoSuchKey":
            return None, False, ROUTE_NO_KEY
        assert e.code == "ServiceUnavailable"
        return None, False, ROUTE_UNAVAILABLE


def _r_scalar(committed, dst, now, cost, unavailable=frozenset()):
    try:
        src, hit = r_choose_get_source(committed, dst, now, cost, unavailable)
        return src, hit, ROUTE_OK
    except RApiError as e:
        return None, False, (ROUTE_NO_KEY if e.code == "NoSuchKey"
                             else ROUTE_UNAVAILABLE)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_route_chunk_fuzz_under_writes(seed):
    rng = np.random.default_rng(seed)
    cost, r_cost = pick_regions(3), r_pick_regions(3)
    names = cost.region_names()
    m = RoutingMatrix(cost)
    committed = {oid: {} for oid in range(40)}
    now, n_fresh, n_stale = 0.0, 0, 0
    for _round in range(10):
        now += 100.0
        down = {r for r in names if rng.random() < 0.2}
        for r in names:
            m.set_outage(r, r in down)
        for oid in range(40):
            for r in names:
                if rng.random() < 0.3:
                    exp = float(now + rng.uniform(-5e3, 5e3))
                    committed[oid][r] = exp
                    m.set_replica(oid, r, exp, float(rng.uniform(1, 1e9)))
        oids = [int(o) for o in rng.integers(0, 44, 30)]   # 40..43: no row
        dsts = [str(rng.choice(names)) for _ in oids]
        nows = [now + float(k) for k in range(len(oids))]
        rows_before = [m.row_of.get(o, -1) for o in oids]
        hints = m.route_chunk(oids, dsts, nows)
        assert hints.rows == rows_before
        # Writes land between the chunk's routing and its consumption.
        written = set()
        for oid in rng.choice(40, size=6, replace=False):
            oid, r = int(oid), str(rng.choice(names))
            if r in committed[oid] and rng.random() < 0.5:
                del committed[oid][r]
                m.drop_replica(oid, r)
            else:
                committed[oid][r] = now + 1e4
                m.set_replica(oid, r, now + 1e4, 64.0)
            written.add(oid)
        for k, oid in enumerate(oids):
            row = hints.rows[k]
            if row < 0:     # no replica ever committed: the scalar path
                assert hints.status[k] == ROUTE_INVALID
                continue
            fresh = hints.live_ver[row] == hints.vers[k]
            assert fresh or oid in written, (oid, written)
            if not fresh:
                n_stale += 1
                continue
            n_fresh += 1
            want = _scalar(committed[oid], dsts[k], nows[k], cost,
                           frozenset(down))
            assert want == _r_scalar(committed[oid], dsts[k], nows[k],
                                     r_cost, frozenset(down))
            assert hints.status[k] == want[2], (k, oid, committed[oid])
            if want[2] != ROUTE_OK:
                continue
            got = (hints.srcs[k], hints.hits[k], hints.status[k])
            assert got == want, (k, oid, committed[oid], dsts[k])
            if not want[1]:
                assert hints.egress[k] == cost.transfer_cost(
                    want[0], dsts[k], m.sizes[row].item())
    assert n_fresh > 100 and n_stale > 10


@pytest.mark.parametrize("policy", ["skystore", "always_evict"])
@pytest.mark.parametrize("outage", [None, "rolling"])
def test_plane_decision_streams_identical_across_routing_engines(policy,
                                                                outage):
    cost = pick_regions(3)
    regs = cost.region_names()
    tr = make_workload("zipfian", regs, seed=7, n_objects=80, n_requests=1500)
    sched = (make_outage_schedule(outage, regs, tr.duration, seed=7)
             if outage else None)
    runs = {eng: (run_sim_plane(tr, cost, policy, routing=eng, outages=sched,
                                device="cpu"),
                  run_live_plane(tr, cost, policy, routing=eng, outages=sched,
                                 device="cpu"))
            for eng in ("matrix", "python")}
    (sim_m, live_m), (sim_p, live_p) = runs["matrix"], runs["python"]
    assert sim_m.decisions == sim_p.decisions
    assert sim_m.report.components() == sim_p.report.components()
    assert live_m.decisions == live_p.decisions
    assert live_m.report.components() == live_p.report.components()
    assert live_m.holders == live_p.holders
    assert sim_m.decisions == live_m.decisions
    r_cost = r_pick_regions(3)
    r_tr = r_make_workload("zipfian", r_cost.region_names(), seed=7,
                           n_objects=80, n_requests=1500)
    r_sched = (r_make_outage_schedule(outage, r_cost.region_names(),
                                      r_tr.duration, seed=7)
               if outage else None)
    r_live = r_run_live_plane(r_tr, r_cost, policy, routing="matrix",
                              outages=r_sched)
    assert live_m.decisions == r_live.decisions
    assert live_m.report.components() == r_live.report.components()


def test_live_plane_routes_through_the_matrix():
    """``routing="auto"`` builds the RoutingMatrix on an LWW metadata
    server, and the live replay drives ``route_chunk`` through it."""
    cost = pick_regions(3)
    tr = make_workload("zipfian", cost.region_names(), seed=7, n_objects=80,
                       n_requests=1500)
    calls = []
    orig = RoutingMatrix.route_chunk

    def counting(self, *args):
        calls.append(len(args[0]))
        return orig(self, *args)

    RoutingMatrix.route_chunk = counting
    try:
        run = run_live_plane(tr, cost, "skystore", device="cpu")
    finally:
        RoutingMatrix.route_chunk = orig
    assert calls and sum(calls) > 500
    meta = run.deciders[1]
    assert isinstance(meta, MetadataServer) and meta.routing is not None


# ---------------------------------------------------------------------------
# Latency streams (§6.3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["skystore", "latency_slo"])
def test_whole_plane_latency_stream_identity(policy):
    cost, r_cost = pick_regions(3), r_pick_regions(3)
    tr = make_workload("zipfian", cost.region_names(), seed=7, n_objects=80,
                       n_requests=1500)
    r_tr = r_make_workload("zipfian", r_cost.region_names(), seed=7,
                           n_objects=80, n_requests=1500)
    r = replay_differential(tr, cost, policy, workload="zipfian",
                            track_latency=True, device="cpu")
    rr = r_replay_differential(r_tr, r_cost, policy, workload="zipfian",
                               track_latency=True)
    assert r.ok(), r.summary_line()
    assert r.latency["max_rel_delta"] == 0.0
    sim, live = r.planes
    assert sim.report.get_latency_ms == live.report.get_latency_ms
    assert sim.report.put_latency_ms == live.report.put_latency_ms
    for k in ("get_mean", "get_p50", "get_p90", "get_p99",
              "put_mean", "put_p50", "put_p90", "put_p99"):
        assert r.latency["sim"][k] == r.latency["live"][k], k
        assert np.isfinite(r.latency["sim"][k]), k
    assert r.latency == rr.latency
    assert r.to_json() == rr.to_json()


def test_untracked_report_keeps_pre_latency_schema():
    cost = pick_regions(3)
    tr = make_workload("zipfian", cost.region_names(), seed=7, n_objects=40,
                       n_requests=400)
    r = replay_differential(tr, cost, "always_evict", workload="zipfian",
                            device="cpu")
    assert r.ok() and r.latency is None and "latency" not in r.to_json()


def test_ledger_records_latency_only_when_tracking():
    cost = _tiny_cats()[0]
    off = CostLedger(cost)
    off.record_get_latency("aws:a", "gcp:c", 1e6)
    off.record_put_latency("aws:a", "gcp:c", 1e6)
    assert off.report.latency_stats() == {}
    on = CostLedger(cost, track_latency=True)
    on.record_get_latency("aws:a", "gcp:c", 1e6)
    on.record_put_latency("aws:a", "gcp:c", 1e6)
    assert on.report.get_latency_ms == [cost.get_latency_ms("aws:a", "gcp:c", 1e6)]
    assert on.report.put_latency_ms == [cost.put_latency_ms("aws:a", "gcp:c", 1e6)]


# ---------------------------------------------------------------------------
# CostLedger
# ---------------------------------------------------------------------------

def _two_region(cm, rg, a_price=0.03, b_price=0.03):
    return cm([rg("aws:a", a_price), rg("aws:b", b_price)],
              {("aws:a", "aws:b"): 0.05, ("aws:b", "aws:a"): 0.05})


def test_ledger_integrates_replica_lifetimes():
    for led in (CostLedger(_two_region(CostModel, Region), horizon=100 * DAY),
                RCostLedger(_two_region(RCostModel, RRegion),
                            horizon=100 * DAY)):
        led.on_replica_commit("b", "k", "aws:a", 1024 ** 3, pinned=False,
                              now=0.0)
        led.on_replica_drop("b", "k", "aws:a", end=30 * DAY)   # one month
        assert led.report.storage == pytest.approx(0.03, rel=1e-12)
        # pinned lifetimes land in storage_base and cap at the horizon
        led.on_replica_commit("b", "k2", "aws:b", 1024 ** 3, pinned=True,
                              now=70 * DAY)
        led.finalize(100 * DAY)
        assert led.report.storage_base == pytest.approx(0.03, rel=1e-12)
        led.charge_transfer("aws:a", "aws:b", 1024 ** 3)
        assert led.report.network == pytest.approx(0.05, rel=1e-12)


def test_ledger_recommit_keeps_lifetime_start():
    led = CostLedger(CostModel([Region("aws:a", 0.03)], {}), horizon=60 * DAY)
    led.on_replica_commit("b", "k", "aws:a", 1024 ** 3, pinned=False, now=0.0)
    led.on_replica_commit("b", "k", "aws:a", 1024 ** 3, pinned=False,
                          now=15 * DAY)   # TTL refresh, not a new lifetime
    led.on_replica_drop("b", "k", "aws:a", end=30 * DAY)
    assert led.report.storage == pytest.approx(0.03, rel=1e-12)


@pytest.mark.parametrize("n_drops", [3, 8, 200])
def test_ledger_lifetime_sums_bit_equal_the_reference(n_drops):
    """Seeded lifetimes, dropped one at a time and as one batched round
    (the vectorized path from 8 drops on): the storage sums are the
    reference's bit for bit -- the charges are accumulated in drop order,
    never by a pairwise reduction."""
    rng = np.random.default_rng(n_drops)
    cat = _two_region(CostModel, Region, 0.023, 0.026)
    r_cat = _two_region(RCostModel, RRegion, 0.023, 0.026)
    starts = rng.uniform(0, 50 * DAY, n_drops)
    ends = starts + rng.uniform(0, 80 * DAY, n_drops)     # some past horizon
    sizes = rng.integers(1, 2 ** 34, n_drops)
    regions = rng.choice(["aws:a", "aws:b"], n_drops)
    pinned = rng.random(n_drops) < 0.3
    order = rng.permutation(n_drops)
    reports = []
    for led in (CostLedger(cat, horizon=90 * DAY),
                CostLedger(cat, horizon=90 * DAY),
                RCostLedger(r_cat, horizon=90 * DAY),
                RCostLedger(r_cat, horizon=90 * DAY)):
        for i in range(n_drops):
            led.on_replica_commit("b", f"k{i}", str(regions[i]),
                                  float(sizes[i]), bool(pinned[i]),
                                  now=float(starts[i]))
        reports.append(led)
    seq, batch, r_seq, r_batch = reports
    for led in (seq, r_seq):
        for i in order:
            led.on_replica_drop("b", f"k{i}", str(regions[i]),
                                end=float(ends[i]), count_eviction=True)
    drops = [("b", f"k{i}", str(regions[i]), float(ends[i]), 0) for i in order]
    batch.on_replica_drop_batch(drops)
    r_batch.on_replica_drop_batch(drops)
    want = r_seq.report.components()
    assert seq.report.components() == want
    assert batch.report.components() == r_batch.report.components()
    assert batch.report.n_evictions == seq.report.n_evictions == n_drops
    if n_drops < CostLedger._VEC_CHARGE_MIN:
        assert batch.report.components() == want


def test_physical_traffic_bounds_match_ledger():
    cost = pick_regions(3)
    tr = make_workload("zipfian", cost.region_names(), seed=7)
    backends = {r: InMemoryBackend(r) for r in cost.region_names()}
    rep = run_live_plane(tr, cost, "skystore", backends=backends,
                         device="cpu").report
    puts = sum(b.op_counts["put"] for b in backends.values())
    gets = sum(b.op_counts["get"] for b in backends.values())
    assert rep.n_put <= puts <= rep.n_put + rep.n_replications
    assert gets >= rep.n_get
    assert sum(b.bytes_in for b in backends.values()) > 0
    assert sum(b.bytes_out for b in backends.values()) > 0


# ---------------------------------------------------------------------------
# Device rule
# ---------------------------------------------------------------------------

def test_live_entry_points_default_to_the_card():
    """Without a Hopper card every entry point of the live plane raises at
    its default ``device="cuda"``; nothing moves to the CPU on its own."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_live_cuda.py "
                    "covers it")
    cost = pick_regions(3)
    backends = {r: InMemoryBackend(r) for r in cost.region_names()}
    tr = make_workload("zipfian", cost.region_names(), seed=7, n_objects=10,
                       n_requests=50)
    for build in (lambda: MetadataServer(cost),
                  lambda: VirtualStore(cost, backends),
                  lambda: VirtualStore(cost, backends,
                                       MetadataServer(cost, device="cpu")),
                  lambda: replay_differential(tr, cost, "always_evict"),
                  lambda: run_live_plane(tr, cost, "always_evict")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    meta = MetadataServer(cost, device="cpu")
    assert meta.device.type == meta.ctl.device.type == "cpu"
    assert VirtualStore(cost, backends, device="cpu").meta.ctl.device.type == "cpu"


def test_the_port_has_the_modules_of_the_live_plane():
    """The live plane's modules stand beside the cost plane's; each is
    imported and scanned by ``tests/test_torch_isolation.py``."""
    from pathlib import Path
    core = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "core"
    assert {"api", "backends", "ledger", "metadata", "virtual_store",
            "replay", "s3_proxy", "lifecycle"} <= {
                p.stem for p in core.glob("*.py")}
