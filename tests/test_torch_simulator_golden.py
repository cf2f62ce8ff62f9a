"""The port's cost plane against the reference's golden replay fixtures.

Each fixture in ``tests/golden/replay/`` pins the reference simulator's
sim-plane dollar components, its counters and, for the outage fixtures, its
availability, for one (workload, outage profile, policy).  The port replays
the same trace with the fixture's parameters (seed 7, ``pick_regions(3)``,
FB mode unless the policy pins FP, daily scan interval, ``routing="auto"``)
on the CPU and must give components within ``GOLDEN_RTOL`` = 1e-9 relative
(the reference's own fixture tolerance) and counters and availability
exactly.  The fixtures are
only read; the reference is not run here, except for the decision-stream
test at the end.
"""

import functools
import json
from pathlib import Path

import pytest

from repro.core.costmodel import pick_regions as r_pick_regions
from repro.core.policies import make_policy as r_make_policy
from repro.core.simulator import Simulator as RSimulator
from repro.core.workloads import make_workload as r_make_workload
from repro_torch.core.costmodel import pick_regions
from repro_torch.core.policies import make_policy
from repro_torch.core.simulator import Simulator, run_policy
from repro_torch.core.workloads import make_outage_schedule, make_workload

GOLDEN_DIR = Path(__file__).resolve().parent / "golden" / "replay"
FIXTURES = sorted(p.stem for p in GOLDEN_DIR.glob("*.json"))
GOLDEN_RTOL = 1e-9
GOLDEN_SEED = 7
DAY = 24 * 3600.0
CAT = pick_regions(3)


@functools.lru_cache(maxsize=None)
def _trace(workload):
    return make_workload(workload, CAT.region_names(), seed=GOLDEN_SEED)


def _replay(workload, outage, policy, **policy_kw):
    trace = _trace(workload)
    sched = (make_outage_schedule(outage, CAT.region_names(), trace.duration,
                                  seed=GOLDEN_SEED) if outage else None)
    sim = Simulator(CAT, make_policy(policy, CAT, device="cpu", **policy_kw),
                    mode="FB", scan_interval=DAY, track_decisions=True,
                    outages=sched)
    return sim.run(trace), sim


def test_fixture_matrix_is_complete():
    assert len(FIXTURES) == 72


@pytest.mark.parametrize("stem", FIXTURES)
def test_sim_plane_matches_golden_fixture(stem):
    want = json.loads((GOLDEN_DIR / f"{stem}.json").read_text())
    wl_part, _, policy = stem.partition("__")
    workload, _, outage = wl_part.partition("@")
    assert (want["workload"], want["policy"]) == (workload, policy)
    report, _sim = _replay(workload, outage, policy)
    assert report.mode == want["mode"]     # SPANStore pins FP itself
    got = report.components()
    assert set(got) == set(want["sim"])
    for k, v in want["sim"].items():
        assert got[k] == pytest.approx(v, rel=GOLDEN_RTOL, abs=0.0), k
    assert report.counters() == want["counters"]
    if outage:
        assert report.availability() == want["availability"]


@pytest.mark.parametrize("engine", ["torch32", "kernel", "torch"])
def test_skystore_decision_stream_matches_python_engine(engine):
    """The port of ``test_plane_level_kernel_vs_python_decision_stream``:
    a float32 or batched engine in the refresh loop leaves every decision and
    every dollar of a replay as the scalar engine has them (``kernel`` on the
    CPU is its plain float32 version)."""
    tr = make_workload("zipfian", CAT.region_names(), seed=13,
                       n_objects=100, n_requests=2500)

    def run(eng):
        sim = Simulator(CAT, make_policy("skystore", CAT, engine=eng,
                                         device="cpu"),
                        mode="FB", track_decisions=True)
        return sim.run(tr), sim.decisions

    rep_py, dec_py = run("python")
    rep, dec = run(engine)
    assert len(dec_py) > 1000
    assert dec == dec_py
    assert rep.components() == rep_py.components()
    assert rep.counters() == rep_py.counters()


@pytest.mark.parametrize("policy", ["skystore", "spanstore", "cgp"])
def test_decision_stream_equals_reference(policy):
    """Decision for decision against the reference simulator (its python
    TTL engine for SkyStore), on the golden zipfian trace."""
    r_cat = r_pick_regions(3)
    r_tr = r_make_workload("zipfian", r_cat.region_names(), seed=GOLDEN_SEED)
    kw = {"engine": "python"} if policy == "skystore" else {}
    r_sim = RSimulator(r_cat, r_make_policy(policy, r_cat, **kw), mode="FB",
                       scan_interval=DAY, track_decisions=True)
    r_rep = r_sim.run(r_tr)
    rep, sim = _replay("zipfian", "", policy)
    assert sim.decisions == r_sim.decisions
    assert sim.replica_holders() == r_sim.replica_holders()
    assert rep.components() == r_rep.components()


def test_run_policy_entry_point():
    trace = _trace("zipfian")
    rep = run_policy(trace, CAT, "skystore", device="cpu")
    want = json.loads((GOLDEN_DIR / "zipfian__skystore.json").read_text())
    assert rep.counters() == want["counters"]
    assert rep.components()["total"] == pytest.approx(
        want["sim"]["total"], rel=GOLDEN_RTOL, abs=0.0)
