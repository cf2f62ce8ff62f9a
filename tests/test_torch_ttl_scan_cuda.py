"""The TTL-scan CUDA kernel against its plain PyTorch version, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper card
and skips itself without one.  The file imports only the port (no JAX), so it
runs as it is on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_ttl_scan_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.costmodel import pick_regions
from repro_torch.core.histogram import cell_edges
from repro_torch.core.policies import make_policy
from repro_torch.core.simulator import Simulator
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


@pytest.mark.parametrize("e_dim,c_dim", [(1, 800), (3, 800), (17, 800),
                                         (64, 800), (5, 123), (2, 1024),
                                         (7, 257), (7, 900), (1000, 800)])
def test_kernel_matches_plain_version_on_card(card, e_dim, c_dim):
    t = [torch.as_tensor(x, device=card).contiguous()
         for x in _problem(e_dim, c_dim, seed=e_dim * 1000 + c_dim)]
    before = ttl_scan.ttl_cost_surface.launches
    got = ttl_scan.ttl_cost_surface(*t)
    want = ref.ttl_cost_ref(*t)
    torch.cuda.synchronize()
    assert ttl_scan.ttl_cost_surface.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_rejects_what_it_does_not_take(card):
    t = [torch.as_tensor(x, device=card).contiguous()
         for x in _problem(4, 800, seed=1)]
    with pytest.raises(TypeError):
        ttl_scan.ttl_cost_surface(t[0].double(), *t[1:])
    with pytest.raises(ValueError):
        ttl_scan.ttl_cost_surface(t[0].t().contiguous().t(), *t[1:])
    with pytest.raises(ValueError):
        ttl_scan.ttl_cost_surface(*t[:3], t[3][:-1], *t[4:])


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
