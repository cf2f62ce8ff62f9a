"""The port's TTL policy against the JAX package's (port of
``tests/test_kernel_plane_equivalence.py``, plus the scalar functions).

Histograms are harvested from the *reference* simulator and carried across
with ``repro_torch.core.histogram.from_numpy``; the reference controller with
``engine="python"`` is the oracle.  Tolerances: TTLs exactly equal on every
engine (they are argmin indices onto the float64 candidate grid); expected
costs bit-equal on the float64 engines (``python``, ``torch``) and within
1e-4 relative on the float32 ones (``torch32``, and ``kernel``, whose CPU
form is the plain float32 version).
"""

import numpy as np
import pytest
import torch

from repro.core.costmodel import pick_regions as r_pick_regions
from repro.core.histogram import AccessHistogram as RHist
from repro.core.histogram import RollingHistogram as RRoll
from repro.core.policies import make_policy as r_make_policy
from repro.core.simulator import Simulator as RSimulator
from repro.core import ttl_policy as R
from repro.core.workloads import make_workload as r_make_workload
from repro_torch.core import ttl_policy as P
from repro_torch.core.costmodel import pick_regions
from repro_torch.core.histogram import AccessHistogram, RollingHistogram
from repro_torch.kernels import ops

PORT_ENGINES = ("python", "torch", "torch32", "kernel")
FLOAT64_ENGINES = ("python", "torch")


@pytest.fixture(scope="module")
def harvest():
    """Windows harvested from a reference replay, as numpy arrays."""
    cat = r_pick_regions(3)
    tr = r_make_workload("zipfian", cat.region_names(), seed=11,
                         n_objects=150, n_requests=4000)
    policy = r_make_policy("skystore", cat)
    RSimulator(cat, policy, mode="FB").run(tr)
    hists = {key: roll.merged() for key, roll in policy.ctl.hists.items()
             if roll.merged().n_samples > 0}
    assert len(hists) >= 3, "harvest produced too few histograms"
    return hists


def _as_args(h):
    return (h.edges, h.hist, h.time_weight, h.last, h.first_read_remote_bytes,
            h.n_samples)


def _reference_controller(hists, engine="python"):
    ctl = R.AdaptiveTTLController(r_pick_regions(3), warmup_min_samples=1,
                                  engine=engine)
    for key, h in hists.items():
        roll = RRoll(h.edges)
        roll.current = RHist(h.edges, h.hist.copy(), h.time_weight.copy(),
                             h.last.copy(), h.first_read_remote_bytes,
                             h.n_samples)
        ctl.hists[key] = roll
    return ctl


def _port_controller(hists, engine):
    ctl = P.AdaptiveTTLController(pick_regions(3), warmup_min_samples=1,
                                  engine=engine, device="cpu")
    for key, h in hists.items():
        ctl.hists[key] = RollingHistogram.from_numpy(*_as_args(h))
    return ctl


def _refresh_all(ctl, hists):
    names = ctl.cost.region_names()
    for (bucket, dst) in list(hists):
        for src in names:
            if src != dst:
                ctl.edge_ttl(bucket, src, dst, now=1.0)
    return {k: (e.ttl_seconds, e.expected_cost)
            for k, e in ctl.edge_ttls.items()}


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_engine_decisions_match_reference_python(engine, harvest):
    want = _refresh_all(_reference_controller(harvest), harvest)
    got = _refresh_all(_port_controller(harvest, engine), harvest)
    assert set(got) == set(want)
    for key, (ttl_w, cost_w) in want.items():
        ttl_g, cost_g = got[key]
        assert ttl_g == ttl_w, f"{engine} chose {ttl_g!r} != {ttl_w!r} on {key}"
        if engine in FLOAT64_ENGINES:
            assert cost_g == cost_w, key
        else:
            assert cost_g == pytest.approx(cost_w, rel=1e-4), key


def test_scalar_and_batched_curves_bit_equal(harvest):
    cat = r_pick_regions(3)
    names = cat.region_names()
    for (bucket, dst), h in harvest.items():
        p = AccessHistogram.from_numpy(*_as_args(h))
        srcs = [s for s in names if s != dst]
        s_gb = cat.storage_price(dst)
        for src in srcs:
            n_gb = cat.egress_price(src, dst)
            for censored in (True, False):
                t_r, c_r = R.expected_cost_curve(h, s_gb, n_gb, censored)
                t_p, c_p = P.expected_cost_curve(p, s_gb, n_gb, censored)
                np.testing.assert_array_equal(t_p.numpy(), t_r)
                np.testing.assert_array_equal(c_p.numpy(), c_r)
            assert P.choose_ttl(p, s_gb, n_gb) == R.choose_ttl(h, s_gb, n_gb)
            for u in (0.0, 0.01, 0.5, 5.0):
                assert (P.choose_ttl_with_perf_value(p, s_gb, n_gb, u)
                        == R.choose_ttl_with_perf_value(h, s_gb, n_gb, u))
        e = len(srcs)
        s = np.full(e, s_gb / R.GB / R.SECONDS_PER_MONTH)
        n = np.asarray([cat.egress_price(x, dst) / R.GB for x in srcs])
        rows = [np.broadcast_to(a, (e, a.shape[0]))
                for a in (h.hist, h.time_weight, h.last)]
        first = np.full(e, h.first_read_remote_bytes)
        t_r, c_r = R.batched_cost_curves(*rows, h.edges, first, s, n)
        t_p, c_p = P.batched_cost_curves(*rows, h.edges, first, s, n)
        np.testing.assert_array_equal(t_p.numpy(), t_r)
        np.testing.assert_array_equal(c_p.numpy(), c_r)


def test_perf_value_controller_matches_reference(harvest):
    """The §3.3.2 lift runs the scalar path on every engine."""
    ctl_r = _reference_controller(harvest)
    ctl_r.u_perf_val_per_gb = 0.05
    want = _refresh_all(ctl_r, harvest)
    ctl_p = _port_controller(harvest, "torch")
    ctl_p.u_perf_val_per_gb = 0.05
    got = _refresh_all(ctl_p, harvest)
    assert got == want


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_all_empty_histogram_stays_in_warmup(engine):
    cat = pick_regions(3)
    ctl = P.AdaptiveTTLController(cat, warmup_min_samples=1, engine=engine,
                                  device="cpu")
    dst, src = cat.region_names()[:2]
    ctl.hist_for("b", dst)
    ttl = ctl.edge_ttl("b", src, dst, now=1.0)
    assert ctl.edge_ttls == {}
    assert ttl == cat.t_even_seconds(src, dst)


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_ttl_zero_wins_exactly(engine):
    cat = pick_regions(3)
    dst, src = cat.region_names()[:2]
    year = 365.0 * 24 * 3600.0
    h = RHist.empty()
    h.add_gaps(np.array([year]), np.array([1024.0]))
    h.add_last(np.array([year]), np.array([1024.0]))
    ctl = P.AdaptiveTTLController(cat, warmup_min_samples=1, engine=engine,
                                  device="cpu")
    ctl.hists[("b", dst)] = RollingHistogram.from_numpy(
        h.edges, h.hist, h.time_weight, h.last, h.first_read_remote_bytes, 1)
    ttl = ctl.edge_ttl("b", src, dst, now=1.0)
    assert ttl == 0.0, f"engine {engine} chose {ttl!r}, want exactly 0.0"


def test_auto_engine_follows_the_device():
    cat = pick_regions(3)
    ctl = P.AdaptiveTTLController(cat, device="cpu")
    assert ctl.engine == "auto"
    assert ctl._resolve_engine() == "torch"
    assert set(P.TTL_ENGINES) == {"auto", "kernel", "torch32", "torch",
                                  "python"}
    with pytest.raises(ValueError, match="unknown TTL engine"):
        P.AdaptiveTTLController(cat, engine="numpy", device="cpu")


def test_cuda_without_a_usable_card_raises(monkeypatch):
    cat = pick_regions(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.AdaptiveTTLController(cat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.AdaptiveTTLController(cat, engine="torch", device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="compute capability"):
        P.AdaptiveTTLController(cat, device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.resolve_device("mps")


def test_controller_refresh_timing_matches_reference(harvest):
    """The cached per-destination table and the per-edge query agree, and
    rotation happens at the same stamps, over a run of refresh periods."""
    ctl_r = _reference_controller(harvest, engine="numpy")
    ctl_p = _port_controller(harvest, "torch")
    names = ctl_p.cost.region_names()
    for step in range(12):
        now = 1.0 + step * 0.4 * ctl_p.refresh_period
        for (bucket, dst) in harvest:
            assert (ctl_p.edge_ttl_table(bucket, dst, now)
                    == ctl_r.edge_ttl_table(bucket, dst, now))
            for src in names:
                assert (ctl_p.edge_ttl(bucket, src, dst, now)
                        == ctl_r.edge_ttl(bucket, src, dst, now))
            assert (ctl_p.object_ttl(bucket, dst, names, now)
                    == ctl_r.object_ttl(bucket, dst, names, now))
    assert ctl_p.last_refresh == ctl_r.last_refresh
    assert ({k: r.window_start for k, r in ctl_p.hists.items()}
            == {k: r.window_start for k, r in ctl_r.hists.items()})
