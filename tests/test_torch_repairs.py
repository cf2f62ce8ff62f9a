"""Three faults of the port closed on the CPU side (their card halves are in
``tests/test_torch_train_cuda.py``):

- the flash kernel has no backward, so ``layers._flash`` raises for
  attention that needs a gradient rather than return an output without a
  ``grad_fn`` (on the card it would launch the kernel; the check comes
  first, so CPU tensors show it);
- a head dim below a compiled one (the reduced configs' 8) is zero-padded
  up to one, with the softmax scale of the true dim: the padded plain path
  equals the unpadded one within 1e-6 of each output's largest |value|;
- ``simulator.build_oracle``, the reference's deprecated alias of
  ``TraceOracle.from_trace``, exists in the port and builds the same
  oracle.
"""

import numpy as np
import pytest
import torch

from repro.core.simulator import build_oracle as r_build_oracle
from repro.core.traces import generate_trace as r_generate_trace
from repro_torch.core import TraceOracle, generate_trace
from repro_torch.core.simulator import build_oracle
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers


def _qkv(b, hq, hkv, sq, skv, d, seed, requires_grad=False):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .requires_grad_(requires_grad)
                 for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def test_flash_raises_under_grad():
    q, k, v = _qkv(1, 4, 2, 8, 8, 64, seed=0, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        layers._flash(q, k, v, causal=True, q_offset=0, window=None,
                      softcap=0.0)
    # Only one input needing a gradient is enough.
    with pytest.raises(NotImplementedError, match="no backward"):
        layers._flash(q.detach(), k.detach(), v, causal=True, q_offset=0,
                      window=None, softcap=0.0)
    with torch.no_grad():
        out = layers._flash(q, k, v, causal=True, q_offset=0, window=None,
                            softcap=0.0)
    assert out.shape == q.shape and out.grad_fn is None


#: (B, Hq, Hkv, Sq, Skv, D, causal, q_offset): the reduced configs' D 8 in
#: prefill and decode, and D 72 / 100 padded to 80 / 128.
PAD_CASES = [
    (2, 4, 4, 16, 16, 8, True, 0),
    (2, 4, 4, 1, 40, 8, True, 31),
    (1, 4, 2, 24, 24, 8, False, 0),
    (1, 8, 2, 20, 20, 72, True, 0),
    (1, 2, 1, 9, 33, 100, True, 24),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,off", PAD_CASES)
def test_padded_head_dim_keeps_the_true_scale(b, hq, hkv, sq, skv, d, causal,
                                              off):
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, seed=d + sq)
    want = fa.plain(q, k, v, causal, off)
    got = layers._flash(q, k, v, causal=causal, q_offset=off, window=None,
                        softcap=0.0)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # The padded call is the plain version at the padded D with the true
    # scale; at the padded D's own scale it would differ.
    padded = min(x for x in fa.HEAD_DIMS if x >= d)
    pad = [torch.nn.functional.pad(t, (0, padded - d)) for t in (q, k, v)]
    wrong = fa.plain(*pad, causal, off)[..., :d]
    assert float((wrong - want).abs().max()) > 1e-3 * float(want.abs().max())


def test_head_dims_above_the_largest_compiled_one_raise():
    q, k, v = _qkv(1, 2, 2, 4, 4, 320, seed=1)
    with pytest.raises(NotImplementedError, match="at most 256"):
        layers._flash(q, k, v, causal=True, q_offset=0, window=None,
                      softcap=0.0)


@pytest.mark.parametrize("name", ["T15", "T65"])
def test_build_oracle_is_trace_oracle_from_trace(name):
    trace = generate_trace(name, seed=3)
    got, want = build_oracle(trace), TraceOracle.from_trace(trace)
    assert type(got) is TraceOracle
    assert vars(got).keys() == vars(want).keys()
    ref = r_build_oracle(r_generate_trace(name, seed=3))
    for oracle in (want, ref):
        for attr in ("_na", "_sizes"):
            table, other = getattr(got, attr), getattr(oracle, attr)
            assert table.keys() == other.keys() and table
            for key in table:
                np.testing.assert_array_equal(table[key], other[key])
        assert got.epoch_len == oracle.epoch_len
