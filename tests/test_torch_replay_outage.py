"""The port's differential replay against the 12 outage golden fixtures.

The §6.4 chaos matrix of the reference: three outage profiles x four
policies on the zipfian golden trace.  Each fixture pins both planes'
components, the counters, zero divergence and the availability metric.  The
port runs ``replay_differential(..., outages=sched, device="cpu")`` and
must show zero divergence, components within 1e-9 relative, counters and
availability exactly as pinned; for SkyStore and CGP its planes' decision
streams (failover routing and 503s included) equal the reference's.
"""

import functools
import json
from pathlib import Path

import pytest

from repro.core.costmodel import pick_regions as r_pick_regions
from repro.core.replay import run_live_plane as r_run_live_plane
from repro.core.replay import run_sim_plane as r_run_sim_plane
from repro.core.workloads import make_outage_schedule as r_make_outage_schedule
from repro.core.workloads import make_workload as r_make_workload
from repro_torch.core.costmodel import pick_regions
from repro_torch.core.replay import (
    COST_RTOL, GOLDEN_OUTAGE_POLICIES, GOLDEN_OUTAGE_PROFILES,
    GOLDEN_OUTAGE_WORKLOAD, GOLDEN_RTOL, GOLDEN_SEED, check_golden,
    golden_path, rel_delta, replay_differential, run_outage_matrix,
)
from repro_torch.core.workloads import make_outage_schedule, make_workload

GOLDEN_DIR = Path(__file__).resolve().parent / "golden" / "replay"
CAT = pick_regions(3)
MATRIX = [(prof, pol) for prof in GOLDEN_OUTAGE_PROFILES
          for pol in GOLDEN_OUTAGE_POLICIES]


@functools.lru_cache(maxsize=None)
def _trace():
    return make_workload(GOLDEN_OUTAGE_WORKLOAD, CAT.region_names(),
                         seed=GOLDEN_SEED)


def _schedule(profile):
    return make_outage_schedule(profile, CAT.region_names(),
                                _trace().duration, seed=GOLDEN_SEED)


@functools.lru_cache(maxsize=None)
def _report(profile, policy):
    return replay_differential(_trace(), CAT, policy,
                               workload=GOLDEN_OUTAGE_WORKLOAD,
                               outages=_schedule(profile), outage=profile,
                               device="cpu")


@pytest.mark.parametrize("profile,policy", MATRIX,
                         ids=[f"{p}__{q}" for p, q in MATRIX])
def test_both_planes_match_outage_fixture(profile, policy):
    r = _report(profile, policy)
    with open(golden_path(str(GOLDEN_DIR), GOLDEN_OUTAGE_WORKLOAD, policy,
                          profile)) as f:
        want = json.load(f)
    assert r.placement_mismatches == [], r.placement_mismatches[:3]
    assert r.holder_mismatches == [], r.holder_mismatches[:3]
    assert r.counter_diffs == {}
    assert r.max_rel_cost_delta <= COST_RTOL
    assert r.ok()
    assert want["outage"] == profile == r.outage
    assert r.sim_counters == want["counters"]
    assert r.availability == want["availability"]
    for plane, got in (("sim", r.sim_costs), ("live", r.live_costs)):
        assert set(got) == set(want[plane])
        for k, v in want[plane].items():
            assert rel_delta(v, got[k]) <= GOLDEN_RTOL, (plane, k, v, got[k])
    assert check_golden([r], str(GOLDEN_DIR)) == []


def test_check_golden_catches_moved_availability():
    r = _report("flaky", "skystore")
    avail = dict(r.availability)
    avail["fraction_served"] *= 1 + 1e-8
    bad = type(r)(**{**r.__dict__, "availability": avail})
    problems = check_golden([bad], str(GOLDEN_DIR))
    assert len(problems) == 1 and "availability.fraction_served" in problems[0]


def test_run_outage_matrix_entry_point():
    reports = run_outage_matrix(policies=("always_evict",),
                                profiles=("single",), device="cpu")
    assert [r.outage for r in reports] == ["single"]
    assert check_golden(reports, str(GOLDEN_DIR)) == []


@pytest.mark.parametrize("profile", GOLDEN_OUTAGE_PROFILES)
@pytest.mark.parametrize("policy", ["skystore", "cgp"])
def test_decision_streams_equal_the_reference_differential(profile, policy):
    r = _report(profile, policy)
    sim, live = r.planes
    r_cat = r_pick_regions(3)
    r_tr = r_make_workload(GOLDEN_OUTAGE_WORKLOAD, r_cat.region_names(),
                           seed=GOLDEN_SEED)
    r_sched = r_make_outage_schedule(profile, r_cat.region_names(),
                                     r_tr.duration, seed=GOLDEN_SEED)
    r_sim = r_run_sim_plane(r_tr, r_cat, policy, outages=r_sched)
    r_live = r_run_live_plane(r_tr, r_cat, policy, outages=r_sched)
    assert sim.decisions == r_sim.decisions
    assert live.decisions == r_live.decisions
    n_503 = sum(d[3] == "error:ServiceUnavailable" for d in live.decisions)
    assert n_503 == r.availability["gets_unavailable"] > 0
    assert live.holders == r_live.holders
    assert live.report.components() == r_live.report.components()
    assert live.report.availability() == r_live.report.availability()
