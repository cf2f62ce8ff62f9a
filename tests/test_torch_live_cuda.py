"""The live plane on the card: every SkyStore refresh of a live replay (and
of a store with no policy, through its metadata server's own controller) is
one launch of the TTL-scan kernel with one copy each way, and decides as the
float64 torch engine on the CPU does.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper card
and skips itself without one.  The file imports only the port (no JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_live_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.api import GetRequest, PutRequest
from repro_torch.core.backends import make_backends
from repro_torch.core.costmodel import pick_regions
from repro_torch.core.metadata import MetadataServer
from repro_torch.core.replay import replay_differential, run_live_plane
from repro_torch.core.virtual_store import VirtualStore
from repro_torch.core.workloads import make_workload
from repro_torch.kernels import ttl_scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel is built "
                    "for sm_90a and has no CPU mode")
    return torch.device("cuda")


def _trace(cat):
    return make_workload("zipfian", cat.region_names(), seed=13,
                         n_objects=100, n_requests=2500)


def _refreshes(run):
    return sum(getattr(d, "ctl", None).n_refreshes for d in run.deciders
               if getattr(d, "ctl", None) is not None)


def test_live_replay_is_one_launch_and_one_copy_each_way_per_refresh(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cat = pick_regions(3)
    tr = _trace(cat)
    run_live_plane(tr, cat, "skystore", device=card)      # build, warm up
    ttl_scan.ttl_cost_surface.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        live = run_live_plane(tr, cat, "skystore", device=card)
        torch.cuda.synchronize()
    refreshes = _refreshes(live)
    assert refreshes > 0
    assert ttl_scan.ttl_cost_surface.launches == refreshes
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    n_kernel = sum("ttl_scan_kernel" in x for x in names)
    n_in = sum("Memcpy HtoD" in x for x in names)
    n_out = sum("Memcpy DtoH" in x for x in names)
    # A long trace may drop a record, never add one.
    assert n_kernel <= refreshes and n_in <= refreshes and n_out <= refreshes
    assert len(names) == n_kernel + n_in + n_out, set(names)
    cpu = run_live_plane(tr, cat, "skystore", device="cpu")
    assert live.decisions == cpu.decisions
    assert live.holders == cpu.holders
    assert live.report.components() == cpu.report.components()
    assert live.report.counters() == cpu.report.counters()


def test_differential_on_the_card_equals_the_cpu(card):
    cat = pick_regions(3)
    tr = _trace(cat)
    ttl_scan.ttl_cost_surface.launches = 0
    r = replay_differential(tr, cat, "skystore", device=card,
                            track_latency=True)
    launches = ttl_scan.ttl_cost_surface.launches
    c = replay_differential(tr, cat, "skystore", device="cpu",
                            track_latency=True)
    assert r.ok() and r.latency["max_rel_delta"] == 0.0
    assert r.to_json() == c.to_json()
    assert launches == sum(_refreshes(p) for p in r.planes) > 0
    for p, q in zip(r.planes, c.planes):
        assert p.decisions == q.decisions


def test_metadata_server_builds_its_controller_on_the_card(card):
    cat = pick_regions(3)
    meta = MetadataServer(cat)
    assert meta.device.type == meta.ctl.device.type == "cuda"
    assert meta.ctl._resolve_engine() == "kernel"
    assert MetadataServer(cat, device="cpu").ctl._resolve_engine() == "torch"


def test_store_without_policy_refreshes_on_the_card(card):
    """A store with no policy takes its TTLs from its metadata server's
    controller: on the card every refresh is a kernel launch, and the
    store's responses and replica tables equal a CPU store's."""
    cat = pick_regions(3)
    regions = cat.region_names()
    stores = []
    for device in (card, "cpu"):
        vs = VirtualStore(cat, make_backends(list(regions), "memory"),
                          mode="FB", clock=lambda: 0.0, device=device)
        vs.create_bucket("b")
        stores.append(vs)
    rng = np.random.default_rng(0)
    ttl_scan.ttl_cost_surface.launches = 0
    t = 0.0
    for i in range(1500):
        t += float(rng.exponential(1800.0))
        key = f"k{i if i < 6 else int(rng.integers(0, 6))}"
        region = regions[int(rng.integers(0, 3))]
        req = (PutRequest("b", key, region, body=bytes(64 + i % 7), at=t)
               if i < 6 or rng.random() < 0.1 else GetRequest("b", key, region, at=t))
        out = [vs.dispatch(req) for vs in stores]
        assert out[0] == out[1]
    on_card, on_cpu = stores
    assert on_card.meta.ctl.device.type == "cuda"
    assert on_card.meta.ctl.n_refreshes > 0
    assert ttl_scan.ttl_cost_surface.launches == on_card.meta.ctl.n_refreshes
    assert on_card.meta.backup() == on_cpu.meta.backup()


def test_store_on_cuda_raises_without_a_card(card, monkeypatch):
    """With no card visible, ``device="cuda"`` (the default) raises for the
    store and the metadata server; it never moves to the CPU."""
    cat = pick_regions(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualStore(cat, make_backends(list(cat.region_names()), "memory"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MetadataServer(cat, device="cuda")
