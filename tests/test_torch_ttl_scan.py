"""The port's TTL-scan kernel module and wrappers against the JAX package's.

Here, on the CPU, the port's wrapper computes the kernel's plain float32
version (``ttl_cost_ref``); the JAX side runs its Pallas kernel in interpret
mode, as its own tests do.  Inputs are drawn with numpy from a seed, as
``tests/test_kernels.py`` draws them.  Tolerance: rtol 2e-5 / atol 1e-4, the
reference sweep's own -- both are float32 surfaces summed in different
orders.  The kernel itself is held against the plain version on the card by
``tests/test_torch_ttl_scan_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.costmodel import pick_regions as r_pick_regions
from repro.core.histogram import cell_edges as r_cell_edges
from repro.core.policies import make_policy as r_make_policy
from repro.core.simulator import Simulator as RSimulator
from repro.core.workloads import make_workload as r_make_workload
from repro.kernels import ops as r_ops
from repro_torch.core.costmodel import pick_regions
from repro_torch.core.histogram import AccessHistogram, from_numpy
from repro_torch.kernels import ops, ref, ttl_scan

RTOL, ATOL = 2e-5, 1e-4
SHAPES = [(1, 800), (3, 800), (17, 800), (64, 800), (5, 123), (2, 1024),
          (7, 257), (7, 900)]


def _problem(e_dim, c_dim, seed):
    rng = np.random.default_rng(seed)
    edges = (r_cell_edges() if c_dim == 800
             else np.cumsum(rng.uniform(1, 100, c_dim)))
    hist = (rng.gamma(0.3, 1e9, (e_dim, c_dim))
            * (rng.random((e_dim, c_dim)) < 0.1)).astype(np.float32)
    time_w = hist * (edges[None] * rng.random((e_dim, c_dim))).astype(np.float32)
    last = (rng.gamma(0.3, 1e9, (e_dim, c_dim))
            * (rng.random((e_dim, c_dim)) < 0.05)).astype(np.float32)
    s = rng.uniform(5e-18, 5e-17, e_dim).astype(np.float32)
    n = rng.uniform(1e-11, 1e-10, e_dim).astype(np.float32)
    first = rng.gamma(1.0, 1e9, e_dim).astype(np.float32)
    return hist, time_w, last, edges.astype(np.float32), s, n, first


@pytest.fixture(scope="module")
def jax_surfaces():
    """The Pallas kernel's surfaces (interpret mode), one per sweep shape."""
    out = {}
    for e_dim, c_dim in SHAPES:
        prob = _problem(e_dim, c_dim, seed=e_dim * 1000 + c_dim)
        _, _, full = r_ops.ttl_scan(*prob, use_kernel=True, interpret=True)
        out[(e_dim, c_dim)] = (prob, np.asarray(full))
    return out


@pytest.mark.parametrize("e_dim,c_dim", SHAPES)
def test_plain_version_vs_pallas_kernel(jax_surfaces, e_dim, c_dim):
    prob, full = jax_surfaces[(e_dim, c_dim)]
    t = [torch.from_numpy(x) for x in prob]
    surf = ref.ttl_cost_ref(*t)
    assert surf.dtype == torch.float32 and surf.shape == (e_dim, c_dim)
    np.testing.assert_allclose(surf.numpy(), full[:, 1:], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("e_dim,c_dim", SHAPES)
def test_ops_ttl_scan_vs_pallas_kernel(jax_surfaces, e_dim, c_dim):
    prob, full = jax_surfaces[(e_dim, c_dim)]
    before = ttl_scan.ttl_cost_surface.launches
    best_ttl, best_cost, got = ops.ttl_scan(*prob, device="cpu")
    # On CPU tensors the wrapper computes the plain version: no launch.
    assert ttl_scan.ttl_cost_surface.launches == before
    np.testing.assert_allclose(got.numpy(), full, rtol=RTOL, atol=ATOL)
    idx = torch.argmin(got, dim=1)
    np.testing.assert_array_equal(best_cost.numpy(),
                                  got[torch.arange(e_dim), idx].numpy())
    cand = np.concatenate([[0.0], prob[3]]).astype(np.float32)
    np.testing.assert_array_equal(best_ttl.numpy(), cand[idx.numpy()])


@pytest.fixture(scope="module")
def harvested():
    """(bucket, dst) windows harvested from a reference replay -- the real
    distribution: sparse cells, censored tails, exact cost-tie plateaus."""
    cat = r_pick_regions(3)
    tr = r_make_workload("zipfian", cat.region_names(), seed=11,
                         n_objects=150, n_requests=4000)
    policy = r_make_policy("skystore", cat)
    RSimulator(cat, policy, mode="FB").run(tr)
    return [roll.merged() for roll in policy.ctl.hists.values()
            if roll.merged().n_samples > 0]


def test_ttl_scan_from_histograms_ttls_equal(harvested):
    """Every window against every incoming edge, as one batch: the port's
    engines choose the reference kernel's TTLs exactly (argmin index onto the
    float64 grid), and its surfaces agree to the sweep tolerance."""
    r_cat, cat = r_pick_regions(3), pick_regions(3)
    names = cat.region_names()
    edges = [(a, b) for a in names for b in names if a != b]
    r_hists = [h for h in harvested for _ in edges]
    targets = edges * len(harvested)
    want_ttl, want_cost, want_surf = r_ops.ttl_scan_from_histograms(
        r_hists, r_cat, targets, engine="kernel", interpret=True)
    p_hists = [from_numpy(h.edges, h.hist, h.time_weight, h.last,
                          h.first_read_remote_bytes, h.n_samples)
               for h in r_hists]
    for engine in ops.SCAN_ENGINES:
        ttl, cost, surf = ops.ttl_scan_from_histograms(
            p_hists, cat, targets, engine=engine, device="cpu")
        assert ttl.dtype == torch.float64
        np.testing.assert_array_equal(ttl.numpy(), want_ttl)
        np.testing.assert_allclose(surf.numpy(), want_surf, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(cost.numpy(), want_cost, rtol=RTOL,
                                   atol=ATOL)


def test_ttl_scan_from_histograms_rejects_mixed_layouts():
    cat = pick_regions(3)
    a = AccessHistogram.empty()
    b = AccessHistogram.empty(a.edges[:-1].clone())
    names = cat.region_names()
    with pytest.raises(ValueError, match="different cell layouts"):
        ops.ttl_scan_from_histograms([a, b], cat, [(names[0], names[1])] * 2,
                                     engine="torch32", device="cpu")
    with pytest.raises(ValueError, match="unknown ttl_scan engine"):
        ops.ttl_scan_from_histograms([a], cat, [(names[0], names[1])],
                                     engine="jax", device="cpu")


def test_canonical_argmin_matches_reference_on_plateaus():
    rng = np.random.default_rng(3)
    surf = rng.uniform(1.0, 2.0, (50, 40))
    surf[:, 10:30] = surf[:, 10:11] * 0.5            # exact plateau
    surf[::2, 12] *= 1.0 - 2.0 ** -24                # wobble inside the band
    surf[1::4, 25] *= 1.0 - 2.0 ** -16               # a real minimum
    np.testing.assert_array_equal(
        ops._canonical_argmin(torch.from_numpy(surf)).numpy(),
        r_ops._canonical_argmin(surf))
    assert ops.TIE_BAND == r_ops.TIE_BAND


def test_kernel_wrapper_rejects_unsupported_devices_and_inputs():
    prob = [torch.from_numpy(x) for x in _problem(2, 123, seed=0)]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ttl_scan.ttl_cost_surface(*[x.to("meta") for x in prob])
    with pytest.raises(ValueError, match="shape"):
        ttl_scan._check(prob[0], prob[1], prob[2], prob[3][:-1], *prob[4:])
    with pytest.raises(TypeError, match="float32"):
        ttl_scan._check(prob[0].double(), *prob[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ttl_scan._check(prob[0].t().contiguous().t(), *prob[1:])
