"""The port's trace inputs and event spine against the JAX package's.

Workloads are drawn with numpy's seeded ``default_rng`` in both packages, so
the event arrays must be equal field for field (no tolerance).  The spine and
the expiry index are plain Python in both: their event streams and pop orders
must be identical, element for element.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import engine as R_engine
from repro.core import expiry as R_expiry
from repro.core import workloads as R_wl
from repro_torch.core import engine as P_engine
from repro_torch.core import expiry as P_expiry
from repro_torch.core import workloads as P_wl
from repro_torch.core.costmodel import pick_regions

DAY = 24 * 3600.0
OUTAGE_PROFILES = ("single", "rolling", "flaky")


def _request_tuple(req):
    """A request as (type name, fields): the two packages' request classes
    differ as types but must carry the same values."""
    if req is None:
        return None
    return (type(req).__name__, dataclasses.astuple(req))


def _assert_traces_equal(p, r):
    assert p.name == r.name
    assert p.regions == r.regions and p.buckets == r.buckets
    assert p.events.dtype == r.events.dtype
    for field in r.events.dtype.names:
        np.testing.assert_array_equal(p.events[field], r.events[field],
                                      err_msg=field)


@pytest.mark.parametrize("name", R_wl.WORKLOAD_NAMES)
def test_default_tier_workloads_equal_event_for_event(name):
    regions = pick_regions(3).region_names()
    r = R_wl.make_workload(name, regions, seed=7)
    p = P_wl.make_workload(name, regions, seed=7)
    _assert_traces_equal(p, r)
    assert ([_request_tuple(q) for q in p.iter_requests()]
            == [_request_tuple(q) for q in r.iter_requests()])
    assert p.stats() == r.stats()


@pytest.mark.parametrize("name", R_wl.WORKLOAD_NAMES)
def test_large_tier_workloads_equal_event_for_event(name):
    regions = pick_regions(9).region_names()
    _assert_traces_equal(P_wl.make_workload(name, regions, seed=7,
                                            tier="large"),
                         R_wl.make_workload(name, regions, seed=7,
                                            tier="large"))


def test_workload_registry_and_tiers_match():
    assert P_wl.WORKLOAD_NAMES == R_wl.WORKLOAD_NAMES
    assert P_wl.WORKLOAD_TIERS == R_wl.WORKLOAD_TIERS


@pytest.mark.parametrize("profile", OUTAGE_PROFILES)
def test_outage_schedules_equal(profile):
    regions = pick_regions(3).region_names()
    r = R_wl.make_outage_schedule(profile, regions, 3e7, seed=7)
    p = P_wl.make_outage_schedule(profile, regions, 3e7, seed=7)
    assert p.transitions() == r.transitions()
    assert ([dataclasses.astuple(w) for w in p.windows]
            == [dataclasses.astuple(w) for w in r.windows])


def _ttl_of(key, region):
    """A deterministic per-replica TTL: ties between replicas of different
    objects and regions, a TTL=0 arm, and re-arms that land inside a drain."""
    return float((int(key) % 5) * 0.25 * DAY + (len(region) % 2) * 3600.0)


def _scalar_stream(pkg_engine, pkg_expiry, trace, sched, epoch_len):
    """The scalar spine's stream, with a consumer that arms an expiry per
    PUT/GET replica and re-arms every third expired object once."""
    idx = pkg_expiry.ExpiryIndex()
    spine = pkg_engine.EventSpine(trace.iter_requests(), idx, DAY,
                                  epoch_len=epoch_len,
                                  horizon=trace.duration + DAY,
                                  outages=sched)
    rearmed, out = set(), []
    for ev in spine:
        out.append((ev.kind, ev.t, _request_tuple(ev.request), ev.ident,
                    ev.epoch, ev.region))
        if ev.kind == pkg_engine.DATA and hasattr(ev.request, "key"):
            req = ev.request
            ident = (int(req.key), req.region)
            idx.arm(ident, ident, ev.t + _ttl_of(req.key, req.region))
        elif ev.kind == pkg_engine.EXPIRE and ev.ident[0] % 3 == 0 \
                and ev.ident not in rearmed:
            rearmed.add(ev.ident)
            idx.arm(ev.ident, ev.ident, ev.t + 600.0)
    return out


def _batched_stream(pkg_engine, pkg_expiry, trace, sched, epoch_len):
    """The same consumer on ``iter_batches``, meeting the ``drain_due``
    obligation before each request."""
    idx = pkg_expiry.ExpiryIndex()
    spine = pkg_engine.EventSpine(trace.iter_requests(), idx, DAY,
                                  epoch_len=epoch_len,
                                  horizon=trace.duration + DAY,
                                  outages=sched)
    rearmed, out = set(), []

    def on_round(pops):
        out.append(("round", [(t, ident) for t, ident in pops]))
        for t, ident in pops:
            if ident[0] % 3 == 0 and ident not in rearmed:
                rearmed.add(ident)
                idx.arm(ident, ident, t + 600.0)

    for b in spine.iter_batches(max_chunk=64):
        if b.kind == pkg_engine.DATA:
            for req in b.requests:
                pkg_engine.EventSpine.drain_due(idx, float(req.at), on_round)
                out.append((b.kind, _request_tuple(req)))
                if hasattr(req, "key"):
                    ident = (int(req.key), req.region)
                    idx.arm(ident, ident,
                            float(req.at) + _ttl_of(req.key, req.region))
        elif b.kind == pkg_engine.EXPIRE:
            on_round(b.pops)
        else:
            out.append((b.kind, b.t, b.epoch, b.region))
    return out


@pytest.mark.parametrize("profile", (None,) + OUTAGE_PROFILES)
def test_spine_streams_identical(profile):
    regions = pick_regions(3).region_names()
    r_tr = R_wl.make_workload("zipfian", regions, seed=7)
    p_tr = P_wl.make_workload("zipfian", regions, seed=7)
    if profile:
        r_sched = R_wl.make_outage_schedule(profile, regions, r_tr.duration,
                                            seed=7)
        p_sched = P_wl.make_outage_schedule(profile, regions, p_tr.duration,
                                            seed=7)
    else:
        r_sched = p_sched = None
    for epoch_len in (None, 3 * DAY):
        want = _scalar_stream(R_engine, R_expiry, r_tr, r_sched, epoch_len)
        got = _scalar_stream(P_engine, P_expiry, p_tr, p_sched, epoch_len)
        assert got == want
        kinds = {e[0] for e in got}
        assert {"data", "expire", "tick", "end"} <= kinds
        if profile:
            assert {"region_down", "region_up"} <= kinds
        if epoch_len:
            assert "epoch" in kinds
        assert (_batched_stream(P_engine, P_expiry, p_tr, p_sched, epoch_len)
                == _batched_stream(R_engine, R_expiry, r_tr, r_sched,
                                   epoch_len))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expiry_index_pop_order_identical(seed):
    """Random arms, re-arms, disarms and infinite expiries with many exact
    ties: pops come in ``(expire, (oid, region))`` order in both."""
    rng = np.random.default_rng(seed)
    r, p = R_expiry.ExpiryIndex(), P_expiry.ExpiryIndex()
    regions = ("aws:us-east-1", "azure:westus", "gcp:us-central1")
    popped = {"r": [], "p": []}
    now = 0.0
    for step in range(3000):
        oid = int(rng.integers(0, 60))
        region = regions[int(rng.integers(0, 3))]
        ident = (oid, region)
        u = rng.random()
        expire = now + float(rng.integers(0, 8)) * 10.0
        for idx in (r, p):
            if u < 0.6:
                idx.arm(ident, ident, expire)
            elif u < 0.7:
                idx.arm(ident, ident, float("inf"))
            elif u < 0.8:
                idx.disarm(ident)
        if step % 50 == 49:
            now += 25.0
            popped["r"].append(r.pop_due_batch(now) if step % 100 == 49
                               else list(r.pop_due(now)))
            popped["p"].append(p.pop_due_batch(now) if step % 100 == 49
                               else list(p.pop_due(now)))
        assert p.peek() == r.peek()
    assert popped["p"] == popped["r"]
    assert len(p) == len(r) and p.n_pops == r.n_pops
    assert sum(len(x) for x in popped["p"]) > 100


def test_key_interner_ids_identical():
    keys = ["17", "obj-a", "0042", "obj-b", "obj-a", "9", "z", "obj-b"]
    r, p = R_expiry.KeyInterner(), P_expiry.KeyInterner()
    assert [p.peek(k) for k in keys] == [r.peek(k) for k in keys]
    assert [p.intern(k) for k in keys] == [r.intern(k) for k in keys]
    assert len(p) == len(r) and P_expiry.KeyInterner.BASE == 1 << 53
