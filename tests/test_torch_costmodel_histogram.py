"""The port's cost model and histograms against the JAX package's.

Both packages get the same inputs, drawn with numpy from a seed.  Tolerance:
none -- the port keeps the reference's float64 arithmetic (CPU
``index_add_`` in place of ``np.add.at``, ``torch.searchsorted`` in place of
``np.searchsorted``), so arrays and prices must be bit-equal.
"""

import numpy as np
import pytest
import torch

from repro.core import costmodel as R_cost
from repro.core import histogram as R_hist
from repro_torch.core import costmodel as P_cost
from repro_torch.core import histogram as P_hist

CATALOGS = ("default_catalog", "paper_2region_catalog", "tpu_tier_catalog")


def _catalog_pairs():
    out = []
    for name in CATALOGS:
        out.append((name, getattr(R_cost, name)(), getattr(P_cost, name)()))
    for n in (3, 6, 9):
        out.append((f"pick_regions({n})", R_cost.pick_regions(n),
                    P_cost.pick_regions(n)))
    return out


def _streams(seed, n=400):
    """Gap and pause streams: log-spread gaps, exact cell boundaries,
    values past the top cell, and many duplicates of one cell."""
    rng = np.random.default_rng(seed)
    edges = R_hist.cell_edges()
    dt = np.concatenate([
        np.exp(rng.uniform(-2, 19, n)),
        edges[rng.integers(0, edges.shape[0], 40)],
        edges[-1] * rng.uniform(1.0, 3.0, 10),
        np.full(30, 90.5),
    ])
    sz = rng.uniform(1e3, 1e9, dt.shape[0])
    age = np.exp(rng.uniform(0, 18, n // 2))
    age_sz = rng.uniform(1e3, 1e9, age.shape[0])
    return dt, sz, age, age_sz


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_hist_equal(p, r):
    for name in ("edges", "hist", "time_weight", "last"):
        np.testing.assert_array_equal(_np(getattr(p, name)), getattr(r, name),
                                      err_msg=name)
    assert p.first_read_remote_bytes == r.first_read_remote_bytes
    assert p.n_samples == r.n_samples


def test_cell_edges_bit_equal():
    np.testing.assert_array_equal(P_hist.cell_edges().numpy(),
                                  R_hist.cell_edges())
    np.testing.assert_array_equal(P_hist.cell_edges(10, 20, 1.1).numpy(),
                                  R_hist.cell_edges(10, 20, 1.1))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_histogram_streams_bit_equal(seed):
    dt, sz, age, age_sz = _streams(seed)
    r, p = R_hist.AccessHistogram.empty(), P_hist.AccessHistogram.empty()
    half = dt.shape[0] // 2
    for h in (r, p):
        h.add_gaps(dt[:half], sz[:half])
        h.add_gaps(dt[half:], sz[half:])
        h.add_gaps(dt[0], sz[0])                  # scalar form
        h.add_last(age, age_sz)
        h.add_last(age[:5], 4096.0)               # broadcast size
        h.add_first_read(1234.0, remote=True)
        h.add_first_read(99.0, remote=False)
    _assert_hist_equal(p, r)
    np.testing.assert_array_equal(p.cell_of(dt).numpy(), r.cell_of(dt))
    np.testing.assert_array_equal(p.t_hat().numpy(), r.t_hat())
    # Whole-array sums are reductions in each library's own order (no
    # decision reads them): equal to 1e-12 relative, not bit for bit.
    assert p.total_reread_bytes == pytest.approx(r.total_reread_bytes,
                                                 rel=1e-12)
    assert p.total_last_bytes == pytest.approx(r.total_last_bytes, rel=1e-12)


@pytest.mark.parametrize("seed", [5, 6])
def test_rolling_histogram_queue_rotate_merge_bit_equal(seed):
    dt, sz, age, age_sz = _streams(seed, n=200)
    r, p = R_hist.RollingHistogram(), P_hist.RollingHistogram()
    for roll in (r, p):
        for x, s in zip(dt[:150], sz[:150]):
            roll.queue_gap(float(x), float(s))
        roll.current.add_last(age, age_sz)
        roll.rotate(1000.0)
        roll.queue_gaps(dt[150:], sz[150:])
        roll.current.add_last(age[:20], age_sz[:20])
    _assert_hist_equal(p.merged(), r.merged())
    assert p.window_start == r.window_start
    m = p.merged()
    m.decay(0.5)                                   # a defensive copy
    _assert_hist_equal(p.merged(), r.merged())


def test_merge_and_decay_bit_equal():
    dt, sz, age, age_sz = _streams(7, n=100)
    pairs = []
    for mod in (R_hist, P_hist):
        a, b = mod.AccessHistogram.empty(), mod.AccessHistogram.empty()
        a.add_gaps(dt[:60], sz[:60])
        b.add_gaps(dt[60:], sz[60:])
        b.add_last(age, age_sz)
        m = a.merge(b)
        m.decay(0.75)
        pairs.append(m)
    _assert_hist_equal(pairs[1], pairs[0])


def test_mismatched_layout_merge_raises():
    a = P_hist.AccessHistogram.empty()
    b = P_hist.AccessHistogram.empty(P_hist.cell_edges(10, 20))
    with pytest.raises(ValueError, match="different cell layouts"):
        a.merge(b)


def test_from_numpy_carries_a_reference_window():
    dt, sz, age, age_sz = _streams(8, n=100)
    r = R_hist.AccessHistogram.empty()
    r.add_gaps(dt, sz)
    r.add_last(age, age_sz)
    r.add_first_read(5e6, remote=True)
    args = (r.edges, r.hist, r.time_weight, r.last,
            r.first_read_remote_bytes, r.n_samples)
    p = P_hist.from_numpy(*args)
    _assert_hist_equal(p, r)
    assert p.hist.dtype == torch.float64 and p.hist.device.type == "cpu"
    roll = P_hist.RollingHistogram.from_numpy(*args)
    _assert_hist_equal(roll.merged(), r)
    r.hist[0] += 1.0                               # loaded by copy
    assert p.hist[0] != r.hist[0]


@pytest.mark.parametrize("name,r_cat,p_cat", _catalog_pairs(),
                         ids=[c[0] for c in _catalog_pairs()])
def test_prices_and_latency_equal_on_every_edge(name, r_cat, p_cat):
    names = r_cat.region_names()
    assert p_cat.region_names() == names
    sizes = (0.0, 1.0, 4096.0, 3.7e7, 2.0**31)
    for src in names:
        assert p_cat.storage_price(src) == r_cat.storage_price(src)
        for op in ("PUT", "GET", "HEAD", "LIST", "delete"):
            assert p_cat.op_cost(src, op, 3) == r_cat.op_cost(src, op, 3)
        for dst in names:
            assert p_cat.egress_price(src, dst) == r_cat.egress_price(src, dst)
            assert (p_cat.t_even_seconds(src, dst)
                    == r_cat.t_even_seconds(src, dst))
            assert (p_cat.latency_params(src, dst)
                    == r_cat.latency_params(src, dst))
            for size in sizes:
                assert (p_cat.get_latency_ms(src, dst, size)
                        == r_cat.get_latency_ms(src, dst, size))
                assert (p_cat.put_latency_ms(src, dst, size)
                        == r_cat.put_latency_ms(src, dst, size))
                assert (p_cat.storage_cost(dst, size, 3600.0 * 7)
                        == r_cat.storage_cost(dst, size, 3600.0 * 7))
                assert (p_cat.transfer_cost(src, dst, size)
                        == r_cat.transfer_cost(src, dst, size))
        for lw in (0.0, 1e-3):
            assert (p_cat.cheapest_source(names, names[0], 4096.0, lw)
                    == r_cat.cheapest_source(names, names[0], 4096.0, lw))
