"""The port's differential replay against the 60 workload golden fixtures.

Each fixture in ``tests/golden/replay/`` pins, for one (workload, policy) of
the reference's evaluation matrix, both planes' dollar components (``sim``
and ``live``), the counters and zero divergence.  The port replays the same
trace (seed 7, ``pick_regions(3)``) through its own Simulator and its own
live VirtualStore with ``replay_differential(device="cpu")`` and must show
zero divergence, components within ``GOLDEN_RTOL`` = 1e-9 relative (the
reference's fixture tolerance) and counters exactly.  ``check_golden`` must
agree, and must catch a component moved by 1e-8.  For SkyStore and CGP both
planes' decision streams equal the reference's own differential's on the
same trace.  The fixtures are only read.  The 12 outage fixtures are in
``test_torch_replay_outage.py``.
"""

import functools
import json
from pathlib import Path

import pytest

from repro.core.costmodel import pick_regions as r_pick_regions
from repro.core.replay import run_live_plane as r_run_live_plane
from repro.core.replay import run_sim_plane as r_run_sim_plane
from repro.core.workloads import make_workload as r_make_workload
from repro_torch.core.costmodel import pick_regions
from repro_torch.core.replay import (
    COST_RTOL, GOLDEN_POLICIES, GOLDEN_RTOL, GOLDEN_SEED, GOLDEN_WORKLOADS,
    check_golden, default_golden_dir, rel_delta, replay_differential,
)
from repro_torch.core.workloads import make_workload

GOLDEN_DIR = Path(__file__).resolve().parent / "golden" / "replay"
CAT = pick_regions(3)
MATRIX = [(wl, pol) for wl in GOLDEN_WORKLOADS for pol in GOLDEN_POLICIES]


@functools.lru_cache(maxsize=None)
def _trace(workload):
    return make_workload(workload, CAT.region_names(), seed=GOLDEN_SEED)


@functools.lru_cache(maxsize=None)
def _report(workload, policy):
    return replay_differential(_trace(workload), CAT, policy,
                               workload=workload, device="cpu")


def _fixture(workload, policy):
    return json.loads((GOLDEN_DIR / f"{workload}__{policy}.json").read_text())


def test_the_port_reads_the_reference_fixture_directory():
    assert Path(default_golden_dir()) == GOLDEN_DIR
    assert len(MATRIX) == 60
    assert all((GOLDEN_DIR / f"{wl}__{pol}.json").is_file()
               for wl, pol in MATRIX)


@pytest.mark.parametrize("workload,policy", MATRIX,
                         ids=[f"{wl}__{pol}" for wl, pol in MATRIX])
def test_both_planes_match_golden_fixture(workload, policy):
    r = _report(workload, policy)
    want = _fixture(workload, policy)
    assert r.placement_mismatches == [], r.placement_mismatches[:3]
    assert r.holder_mismatches == [], r.holder_mismatches[:3]
    assert r.counter_diffs == {}
    assert r.max_rel_cost_delta <= COST_RTOL
    assert r.ok()
    assert r.mode == want["mode"]
    assert r.n_events == want["n_events"]
    assert r.n_get_checked == want["n_get_checked"]
    assert r.sim_counters == want["counters"]
    for plane, got in (("sim", r.sim_costs), ("live", r.live_costs)):
        assert set(got) == set(want[plane])
        for k, v in want[plane].items():
            assert rel_delta(v, got[k]) <= GOLDEN_RTOL, (plane, k, v, got[k])
    assert "availability" not in r.to_json()
    assert check_golden([r], str(GOLDEN_DIR)) == []


def test_check_golden_catches_a_component_moved_by_1e_8():
    """The control: one live component scaled by (1 + 1e-8) in memory must
    be reported, and the sim block likewise."""
    r = _report("zipfian", "skystore")
    for plane in ("live_costs", "sim_costs"):
        costs = dict(getattr(r, plane))
        bad = type(r)(**{**r.__dict__, plane: {
            **costs, "storage": costs["storage"] * (1 + 1e-8)}})
        problems = check_golden([bad], str(GOLDEN_DIR))
        assert len(problems) == 1 and ".storage drifted" in problems[0]


@pytest.mark.parametrize("workload", GOLDEN_WORKLOADS)
@pytest.mark.parametrize("policy", ["skystore", "cgp"])
def test_decision_streams_equal_the_reference_differential(workload, policy):
    """Both planes' per-GET decisions, holders and epoch sets are the
    reference's own planes' on the same trace, and the report's JSON is the
    reference's report's."""
    r = _report(workload, policy)
    sim, live = r.planes
    r_cat = r_pick_regions(3)
    r_tr = r_make_workload(workload, r_cat.region_names(), seed=GOLDEN_SEED)
    r_sim = r_run_sim_plane(r_tr, r_cat, policy)
    r_live = r_run_live_plane(r_tr, r_cat, policy)
    assert len(sim.decisions) == r.n_get_checked > 100
    assert sim.decisions == r_sim.decisions
    assert live.decisions == r_live.decisions
    assert sim.holders == r_sim.holders
    assert live.holders == r_live.holders
    assert live.epoch_sets == r_live.epoch_sets
    assert live.report.components() == r_live.report.components()
    assert live.report.counters() == r_live.report.counters()
