"""The TTL-scan CUDA kernel against its plain PyTorch version, on the card:
the surface (rtol 2e-5 / atol 1e-4, float32 summed in another order), the
fused decision (the index exactly the plain rule's on the kernel's own
surface), one shared histogram row against stacked rows (bit-equal), and
the controller's refresh (one copy in, one launch, one copy out).

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper card
and skips itself without one.  The file imports only the port (no JAX), so it
runs as it is on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_ttl_scan_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.costmodel import pick_regions
from repro_torch.core.histogram import cell_edges, from_numpy
from repro_torch.core.policies import make_policy
from repro_torch.core.simulator import Simulator
from repro_torch.core.ttl_policy import AdaptiveTTLController
from repro_torch.core.workloads import make_workload
from repro_torch.kernels import ref, ttl_scan

pytestmark = pytest.mark.cuda

#: Kernel vs plain version: float32 surfaces summed in another order.
RTOL, ATOL = 2e-5, 1e-4


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel is built "
                    "for sm_90a and has no CPU mode")
    return torch.device("cuda")


def _problem(e_dim, c_dim, seed):
    rng = np.random.default_rng(seed)
    edges = (cell_edges().numpy() if c_dim == 800
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


#: The CPU tests' sweep shapes (C = 123 and 257 take the scalar loads) and
#: E = 1,000.
SHAPES = [(1, 800), (3, 800), (17, 800), (64, 800), (5, 123), (2, 1024),
          (7, 123), (7, 257), (7, 900), (1000, 800)]


def _on_card(card, e_dim, c_dim, seed=None):
    seed = e_dim * 1000 + c_dim if seed is None else seed
    return [torch.as_tensor(x, device=card).contiguous()
            for x in _problem(e_dim, c_dim, seed)]


@pytest.mark.parametrize("e_dim,c_dim", SHAPES)
def test_kernel_matches_plain_version_on_card(card, e_dim, c_dim):
    t = _on_card(card, e_dim, c_dim)
    before = ttl_scan.ttl_cost_surface.launches
    got = ttl_scan.ttl_cost_surface(*t)
    want = ref.ttl_cost_ref(*t)
    torch.cuda.synchronize()
    assert ttl_scan.ttl_cost_surface.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_rejects_what_it_does_not_take(card):
    t = _on_card(card, 4, 800, seed=1)
    before = ttl_scan.ttl_cost_surface.launches
    for fn in (ttl_scan.ttl_cost_surface, ttl_scan.ttl_decision):
        with pytest.raises(TypeError):
            fn(t[0].double(), *t[1:])
        with pytest.raises(ValueError):
            fn(t[0].t().contiguous().t(), *t[1:])
        with pytest.raises(ValueError):
            fn(*t[:3], t[3][:-1], *t[4:])
        with pytest.raises(ValueError):
            fn(*[torch.zeros(1, 4097, device=card)] * 3,
               torch.zeros(4097, device=card),
               *[torch.zeros(1, device=card)] * 3)
    assert ttl_scan.ttl_cost_surface.launches == before


@pytest.mark.parametrize("e_dim,c_dim", SHAPES)
def test_kernel_index_is_the_plain_rule_on_its_own_surface(card, e_dim, c_dim):
    """The fused decision takes exactly the index the plain rule takes from
    the kernel's own [E, C+1] surface, and the cost there; its surface and
    TTL = 0 column agree with the plain version's."""
    t = _on_card(card, e_dim, c_dim)
    before = ttl_scan.ttl_cost_surface.launches
    idx, best, zero, surf = ttl_scan.ttl_decision(*t, surface=True)
    torch.cuda.synchronize()
    assert ttl_scan.ttl_cost_surface.launches == before + 1
    full = torch.cat([zero[:, None], surf], dim=1).cpu()
    want = ref.canonical_argmin(full)
    assert torch.equal(idx.cpu().long(), want)
    assert torch.equal(best.cpu(), full[torch.arange(e_dim), want])
    _, _, p_zero, p_surf = ref.ttl_decision_ref(*t)
    torch.testing.assert_close(surf, p_surf, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(zero, p_zero, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("e_dim,c_dim", [(8, 800), (7, 257), (1000, 800)])
def test_shared_row_is_bit_equal_to_stacked_rows(card, e_dim, c_dim):
    """Row stride 0 (one histogram for every row, as a controller refresh
    passes it) gives what the same row stacked E times gives, bit for bit;
    a launch without the surface gives the same decision as one with it."""
    t = _on_card(card, e_dim, c_dim)
    shared = [x[:1].expand(e_dim, c_dim) for x in t[:3]] + t[3:]
    stacked = [x.contiguous() for x in shared[:3]] + t[3:]
    got = ttl_scan.ttl_decision(*shared, surface=True)
    want = ttl_scan.ttl_decision(*stacked, surface=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(ttl_scan.ttl_cost_surface(*shared),
                       ttl_scan.ttl_cost_surface(*stacked))
    for w in (shared, stacked):
        no_surf = ttl_scan.ttl_decision(*w)
        assert no_surf[3] is None
        for a, b in zip(no_surf[:3], want[:3]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("c_dim", [800, 123])
def test_unaligned_rows_take_the_scalar_loads(card, c_dim):
    """Rows that do not start 16 bytes apart go through the scalar loads and
    give what the aligned rows give."""
    e_dim = 9
    t = _on_card(card, e_dim, c_dim)
    moved = []
    for x in t[:3]:
        buf = torch.zeros(e_dim * c_dim + 1, device=card)
        buf[1:] = x.flatten()
        moved.append(buf[1:].view(e_dim, c_dim))
    assert moved[0].data_ptr() % 16
    got = ttl_scan.ttl_decision(*moved, *t[3:], surface=True)
    want = ttl_scan.ttl_decision(*t, surface=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_controller_refresh_is_one_copy_each_way_and_one_launch(card):
    """A kernel-engine refresh of 8 incoming edges: one host-to-device copy,
    one launch and one device-to-host copy on the card, by the profiler's
    device events; its TTLs equal the float64 torch engine's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cat = pick_regions(9)
    dst = cat.region_names()[0]
    srcs = [r for r in cat.region_names() if r != dst]
    h, tw, last, edges, _s, _n, first = _problem(1, 800, seed=9)
    merged = from_numpy(edges.astype(np.float64), h[0], tw[0], last[0],
                        float(first[0]), 100)
    ctl = AdaptiveTTLController(cat, engine="kernel", device=card)
    ctl._refresh_batched(merged, dst, srcs, "kernel")   # build, edges upload
    before = ttl_scan.ttl_cost_surface.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ttls, costs = ctl._refresh_batched(merged, dst, srcs, "kernel")
        torch.cuda.synchronize()
    assert ttl_scan.ttl_cost_surface.launches == before + 1
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    assert sum("ttl_scan_kernel" in x for x in names) == 1, names
    assert sum("Memcpy HtoD" in x for x in names) == 1, names
    assert sum("Memcpy DtoH" in x for x in names) == 1, names
    assert len(names) == 3, names
    want_ttls, want_costs = AdaptiveTTLController(
        cat, engine="torch", device="cpu")._refresh_batched(
            merged, dst, srcs, "torch")
    assert ttls.tolist() == want_ttls.tolist()
    torch.testing.assert_close(costs, want_costs, rtol=RTOL, atol=ATOL)


def test_kernel_engine_replay_matches_torch_engine(card):
    cat = pick_regions(3)
    tr = make_workload("zipfian", cat.region_names(), seed=13,
                       n_objects=100, n_requests=2500)

    def run(engine, device):
        sim = Simulator(cat, make_policy("skystore", cat, engine=engine,
                                         device=device),
                        mode="FB", track_decisions=True)
        return sim.run(tr), sim.decisions

    rep_k, dec_k = run("kernel", card)
    rep_t, dec_t = run("torch", "cpu")
    assert dec_k == dec_t
    assert rep_k.components() == rep_t.components()
    assert rep_k.counters() == rep_t.counters()
