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
        ref.canonical_argmin(torch.from_numpy(surf)).numpy(),
        r_ops._canonical_argmin(surf))
    assert ref.TIE_BAND == r_ops.TIE_BAND


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


def test_numpy_inputs_without_a_device_go_to_the_card(monkeypatch):
    """Like every entry point, ``ops.ttl_scan`` runs on the card unless told
    otherwise: numpy inputs and no ``device`` raise where there is no card,
    never run on the CPU on their own; tensors keep their own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = _problem(3, 800, seed=1)
    before = ttl_scan.ttl_cost_surface.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.ttl_scan(*prob)
    _, _, full = ops.ttl_scan(*(torch.from_numpy(x) for x in prob))
    assert full.device.type == "cpu"
    assert ttl_scan.ttl_cost_surface.launches == before


# -- the fused decision -------------------------------------------------------

def _priced_windows(harvested, cat):
    """Each harvested window against every incoming edge of one destination,
    as the controller refreshes it: one shared histogram, E prices."""
    from repro_torch.core.costmodel import GB, SECONDS_PER_MONTH

    dst = cat.region_names()[0]
    srcs = [r for r in cat.region_names() if r != dst]
    s = torch.full((len(srcs),), cat.storage_price(dst) / GB / SECONDS_PER_MONTH,
                   dtype=torch.float64)
    n = torch.tensor([cat.egress_price(src, dst) / GB for src in srcs],
                     dtype=torch.float64)
    return dst, srcs, s, n


def test_decision_op_equals_from_histograms_and_reference(harvested):
    """The controller's decision op (one shared histogram, no surface) takes
    the TTLs and costs of ``ttl_scan_from_histograms`` and of the JAX
    package's ``ttl_scan_from_histograms`` (Pallas kernel, interpret mode)
    on every harvested window."""
    r_cat, cat = r_pick_regions(3), pick_regions(3)
    dst, srcs, s, n = _priced_windows(harvested, cat)
    targets = [(src, dst) for src in srcs]
    for h in harvested:
        p = from_numpy(h.edges, h.hist, h.time_weight, h.last,
                       h.first_read_remote_bytes, h.n_samples)
        ttl, cost, surf = ops._ttl_decide(p, s, n, torch.device("cpu"))
        assert surf is None and ttl.dtype == cost.dtype == torch.float64
        want_ttl, want_cost, _ = ops.ttl_scan_from_histograms(
            [p] * len(srcs), cat, targets, engine="kernel", device="cpu")
        np.testing.assert_array_equal(ttl.numpy(), want_ttl.numpy())
        np.testing.assert_array_equal(cost.numpy(), want_cost.numpy())
        r_ttl, r_cost, _ = r_ops.ttl_scan_from_histograms(
            [h] * len(srcs), r_cat, targets, engine="kernel", interpret=True)
        np.testing.assert_array_equal(ttl.numpy(), r_ttl)
        np.testing.assert_allclose(cost.numpy(), r_cost, rtol=RTOL, atol=ATOL)


def test_shared_row_packing_equals_stacked_rows(harvested):
    """One histogram shared by every row (stride 0 on the card) gives the
    surfaces and decisions of the same histogram stacked once per row."""
    cat = pick_regions(3)
    _dst, _srcs, s, n = _priced_windows(harvested, cat)
    for h in harvested[:12]:
        p = from_numpy(h.edges, h.hist, h.time_weight, h.last,
                       h.first_read_remote_bytes, h.n_samples)
        copies = [p.copy() for _ in range(s.shape[0])]
        shared = ops._ttl_decide(p, s, n, torch.device("cpu"), surface=True)
        stacked = ops._ttl_decide(copies, s, n, torch.device("cpu"),
                                  surface=True)
        for a, b in zip(shared, stacked):
            assert torch.equal(a, b)


#: Constructed rows with known decisions, exact in float32: s = 1, n = 2^22,
#: first = 0, edges 1, 2, ..., C.  A re-read of 1 byte in cell K1 with
#: t_hat 0 and one in cell K2 with t_hat T2 make the costs
#:   TTL = 0: 2^23;  cells before K1: 2^23 + 2 e_j;
#:   cells K1 .. K2-1: A + (j - K1), A = 2^22 + K1 + 1;  cells from K2: T2,
#: an exact plateau.  ``delta`` is A - T2: 2 is 2^-21 of A (inside the tie
#: band: the earlier candidate K1 must win), 8 is 2^-19 (outside: the
#: plateau start K2 must win).  The "ttl0" row has one re-read with t_hat
#: 2^23 > n / s, so TTL = 0 (cost 2^22) wins.
N_TIE = 2.0 ** 22
K1 = 10


def tie_rows(c_dim):
    """[(name, inputs, want_index, raw_argmin_index)] for C cells."""
    k2 = min(c_dim - 3, 700)
    a = N_TIE + K1 + 1
    edges = np.arange(1, c_dim + 1, dtype=np.float32)
    rows = []
    for name, t2 in (("plateau", a - 64), ("near_2^-21", a - 2),
                     ("near_2^-19", a - 8), ("ttl0", None)):
        hist = np.zeros((1, c_dim), np.float32)
        time_w = np.zeros((1, c_dim), np.float32)
        if t2 is None:
            hist[0, k2], time_w[0, k2] = 1.0, 2.0 ** 23
            want = raw = 0
        else:
            hist[0, K1] = hist[0, k2] = 1.0
            time_w[0, k2] = t2
            want = K1 + 1 if name == "near_2^-21" else k2 + 1
            raw = k2 + 1
        prob = (hist, time_w, np.zeros_like(hist), edges,
                np.ones(1, np.float32), np.full(1, N_TIE, np.float32),
                np.zeros(1, np.float32))
        rows.append((name, prob, want, raw))
    return rows


@pytest.mark.parametrize("c_dim", [800, 123, 257])
@pytest.mark.parametrize("case", range(4))
def test_plain_decision_takes_the_plateau_start(c_dim, case):
    """The plain decision version on constructed rows: the exact plateau's
    start, the earlier candidate inside the tie band, the later one outside
    it, and TTL = 0 -- the same index as the JAX package's rule on the
    Pallas kernel's surface (interpret mode)."""
    name, prob, want, raw = tie_rows(c_dim)[case]
    idx, best, zero, surf = ref.ttl_decision_ref(
        *(torch.from_numpy(x) for x in prob))
    full = torch.cat([zero[:, None], surf], dim=1)
    assert int(idx[0]) == want, name
    assert int(torch.argmin(full, dim=1)[0]) == raw, name
    assert float(best[0]) == float(full[0, want])
    _, _, r_full = r_ops.ttl_scan(*prob, use_kernel=True, interpret=True)
    np.testing.assert_array_equal(full.numpy(), np.asarray(r_full))
    assert int(r_ops._canonical_argmin(np.asarray(r_full))[0]) == want


def test_ttl_decision_wrapper_on_cpu_is_the_plain_version():
    prob = [torch.from_numpy(x) for x in _problem(7, 257, seed=5)]
    before = ttl_scan.ttl_cost_surface.launches
    idx, best, zero, surf = ttl_scan.ttl_decision(*prob, surface=True)
    assert ttl_scan.ttl_cost_surface.launches == before
    r_idx, r_best, r_zero, r_surf = ref.ttl_decision_ref(*prob)
    assert idx.dtype == torch.int32
    assert torch.equal(idx.long(), r_idx) and torch.equal(best, r_best)
    assert torch.equal(zero, r_zero) and torch.equal(surf, r_surf)
    assert ttl_scan.ttl_decision(*prob)[3] is None


def test_kernel_wrapper_takes_a_shared_row_and_rejects_the_rest():
    prob = [torch.from_numpy(x) for x in _problem(3, 800, seed=2)]
    row = [x[:1].expand(3, 800) for x in prob[:3]]
    assert ttl_scan._check(*row, *prob[3:]) == 0
    assert ttl_scan._check(*prob) == 800
    with pytest.raises(ValueError, match="one row layout"):
        ttl_scan._check(row[0], *prob[1:])
    with pytest.raises(ValueError, match="unsupported problem size"):
        ttl_scan._check(*[torch.zeros(1, 4097)] * 3, torch.zeros(4097),
                        *[torch.zeros(1)] * 3)
