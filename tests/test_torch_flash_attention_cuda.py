"""The flash-attention CUDA kernel against its plain PyTorch version, on the
card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper card
and skips itself without one.  The file imports only the port (no JAX), so it
runs as it is on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_attention_cuda.py

Cases: the six of ``tests/test_kernels.py::test_flash_attention_vs_oracle``,
the shape of its ``test_flash_attention_block_sweep`` (the TPU block sizes
are the kernel's own here) and the serving path's prefill and decode
shapes.  Tolerance: the reference
sweep's own, 2e-5 in f32 and 2e-2 in bf16 (the kernel rounds the pre-scaled
q to bf16 and keeps p in fp32; the plain version scales fp32 logits).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import init_params, layers
from repro_torch.serve import prefill, serve_step

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16
CASES = [
    (2, 4, 2, 256, 256, 64, True, 0, F32),
    (1, 2, 2, 128, 384, 128, False, 0, F32),
    (1, 4, 1, 1, 512, 64, True, 511, F32),
    (2, 2, 2, 200, 200, 80, True, 0, F32),
    (1, 8, 4, 130, 257, 96, True, 0, F32),
    (2, 4, 4, 256, 256, 64, True, 0, BF16),
    (1, 2, 2, 384, 384, 64, True, 0, F32),         # the block-sweep shape
    (4, 32, 8, 1024, 1024, 64, True, 0, BF16),     # serving prefill
    (4, 32, 8, 1, 1056, 64, True, 1040, BF16),     # serving decode
]


def _qkv(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel is built "
                    "for sm_90a and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,off,dtype", CASES)
def test_kernel_matches_plain_version_on_card(card, b, hq, hkv, sq, skv, d,
                                              causal, off, dtype):
    q, k, v = (torch.from_numpy(x).to(card, dtype)
               for x in _qkv(b, hq, hkv, sq, skv, d, seed=b * 31 + sq + skv))
    before = fa.flash_attention_bshd.launches
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    swap = (lambda x: x.transpose(1, 2))
    want = swap(fa.plain(swap(q), swap(k), swap(v), causal, off))
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.launches == before + 1
    tol = 2e-5 if dtype == F32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_kernel_rejects_what_it_does_not_take(card):
    q, k, v = (torch.from_numpy(x).to(card) for x in
               _qkv(1, 4, 2, 8, 8, 64, seed=1))
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k, v)
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :1].expand(1, 3, 8, 64), v[:, :1].expand(1, 3, 8, 64))
    with pytest.raises(NotImplementedError):
        layers._flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=True, q_offset=0, window=4, softcap=0.0)


def test_model_attention_goes_through_the_kernel(card):
    """On the card the model's prefill and decode attention launch the
    kernel once per layer call, and the sliding-window layers raise."""
    cfg = get_config("llama3.2-1b").reduced()
    cfg = dataclasses.replace(cfg, head_dim=64, d_model=64 * cfg.n_heads)
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=card)
    before = fa.flash_attention_bshd.launches
    lg, caches, pos = prefill(cfg, params, toks, max_len=48)
    lg, caches = serve_step(cfg, params, caches, toks[:, -1:], pos)
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.launches == before + 2 * cfg.n_layers
    swa = get_config("gemma3-4b").reduced()
    swa = dataclasses.replace(swa, head_dim=64, d_model=64 * swa.n_heads)
    swa_params = init_params(torch.Generator(device=card).manual_seed(1), swa)
    with pytest.raises(NotImplementedError, match="sliding window"):
        prefill(swa, swa_params, toks, max_len=48)
