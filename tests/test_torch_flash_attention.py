"""The port's flash-attention op against the JAX package's.

On the CPU the port's wrapper computes the kernel's plain version; the JAX
side runs its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
runs it.  Inputs are drawn with numpy from a seed and rounded to bf16 the
same way on both sides.  Tolerance: the reference sweep's own, 2e-5 in f32
(sums in another order) and 2e-2 in bf16 (the TPU kernel rounds the
pre-scaled q to bf16; the plain version scales fp32 logits).

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_flash_attention_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.models import layers as r_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

#: The six cases of tests/test_kernels.py::test_flash_attention_vs_oracle.
CASES = [
    (2, 4, 2, 256, 256, 64, True, 0, jnp.float32),
    (1, 2, 2, 128, 384, 128, False, 0, jnp.float32),
    (1, 4, 1, 1, 512, 64, True, 511, jnp.float32),
    (2, 2, 2, 200, 200, 80, True, 0, jnp.float32),
    (1, 8, 4, 130, 257, 96, True, 0, jnp.float32),
    (2, 4, 4, 256, 256, 64, True, 0, jnp.bfloat16),
]


def _tol(dtype):
    return 2e-5 if dtype in (jnp.float32, torch.float32) else 2e-2


def _qkv(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,off,dtype", CASES)
def test_plain_op_vs_pallas_kernel(b, hq, hkv, sq, skv, d, causal, off, dtype):
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, seed=b * 31 + sq + skv)
    want = r_ops.flash_attention(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
        causal=causal, q_offset=off, interpret=True)
    before = fa.flash_attention_bshd.launches
    got = ops.flash_attention(
        *(torch.from_numpy(x).to(TORCH_DTYPE[dtype]) for x in (q, k, v)),
        causal=causal, q_offset=off)
    assert fa.flash_attention_bshd.launches == before   # CPU: no launch
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, hq, sq, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,t,pos", [(1, 24, 0), (1, 24, 13), (1, 24, 23),
                                     (9, 9, None), (16, 40, None)])
def test_model_calls_map_onto_the_kernels_contract(s, t, pos):
    """The model's attention calls, as the kernel path makes them, equal the
    reference's ``_sdpa`` calls: prefill is causal at q_offset 0, a decode
    step is causal at q_offset=pos over the padded cache, which the
    reference writes as causal=False, kv_valid=pos."""
    rng = np.random.default_rng(s * 100 + t)
    q = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    decode = pos is not None
    mask = (dict(causal=False, kv_valid=pos) if decode
            else dict(causal=True))
    want = r_layers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kernel_path = fa.flash_attention_bshd(tq, tk, tv, causal=True,
                                          q_offset=pos if decode else 0)
    plain_path = layers._sdpa(tq, tk, tv, **mask)
    for got in (kernel_path, plain_path):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_strided_layouts_go_in_without_copies():
    """The op's [B, H, S, D] tensors reach the kernel as views of
    [B, S, H, D]; a sliced cache (the decode path's) is another stride."""
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(2, 4, 2, 5, 40, 64, seed=3))
    cache_k = torch.zeros(3, 2, 48, 2, 64)
    cache_k[1, :, :40] = k.transpose(1, 2)
    cache_v = torch.zeros_like(cache_k)
    cache_v[1, :, :40] = v.transpose(1, 2)
    want = ops.flash_attention(q, k, v, causal=True, q_offset=35)
    got = fa.flash_attention_bshd(q.transpose(1, 2), cache_k[1, :, :40],
                                  cache_v[1, :, :40], causal=True,
                                  q_offset=35)
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=0, atol=0)
