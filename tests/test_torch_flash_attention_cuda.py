"""The flash-attention CUDA kernels against their plain PyTorch version, on
the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper card
and skips itself without one.  The file imports only the port (no JAX), so it
runs as it is on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_attention_cuda.py

Cases: the six of ``tests/test_kernels.py::test_flash_attention_vs_oracle``,
the shape of its ``test_flash_attention_block_sweep`` (the TPU block sizes
are the kernel's own here) and the serving path's prefill and decode
shapes; the f32 ``simt`` kernel at short lengths, where a block's row tile
is mostly empty.  Then each bf16 route forced on the cases it takes:
``wgmma`` (prefill at D 64 / 128 with query groups of 4, 1, 2, 7 and 8, and
at D 80 / 96 on the padded tile, causal or not, hubert-xlarge's call at
S 1000 among them) and ``splitkv`` (at most 64 query rows per KV head: the
serving decode, an 8,192-key cache, group 7 at D 128, D 80 / 96, short
chunks); the ``[B, H, S, D]`` view; determinism of decode; the 16-byte
alignment every route needs; and each route's counter against the plan.
Tolerance: the reference sweep's own, 2e-5 in f32 and 2e-2 in bf16 (the
kernels round the pre-scaled q to bf16, and ``wgmma`` rounds p to bf16 for
its second product; the plain version scales fp32 logits and keeps p in
fp32).  The forced routes are held besides to 2**-5 of each output row's
largest value, which sees a key or split left out of a long decode.
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
    (1, 32, 8, 256, 256, 64, True, 0, F32),        # the f32 gate's call
    (1, 8, 2, 100, 356, 96, True, 256, F32),       # an f32 chunk at an offset
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


#: f32 calls shorter than a block's row tile (32 rows at D 64, 16 above)
#: or just past it, against few keys and against many: every row written,
#: each warp's share of the keys merged (B, Hq, Hkv, Sq, Skv, D, causal, off).
SHORT_F32 = [
    (3, 6, 2, 5, 5, 64, True, 0),
    (2, 4, 4, 33, 40, 128, False, 0),
    (1, 8, 1, 3, 700, 80, True, 697),
    (2, 2, 1, 17, 17, 96, True, 0),
    (1, 4, 4, 9, 1, 64, False, 0),
]


@pytest.mark.parametrize("case", SHORT_F32, ids=lambda c: "-".join(map(str, c)))
def test_simt_covers_every_row_at_short_lengths(card, case):
    b, hq, hkv, sq, skv, d, causal, off = case
    q, k, v = (torch.from_numpy(x).to(card).transpose(1, 2)
               for x in _qkv(b, hq, hkv, sq, skv, d, seed=sq * 7 + skv))
    assert fa.plan(q, k, causal, off)[0] == "simt"
    got = fa.flash_attention_bshd(q, k, v, causal=causal, q_offset=off)
    want = fa.plain(q, k, v, causal, off)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


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


#: (B, Hq, Hkv, Sq, Skv, D, causal, q_offset, route), all bf16.
ROUTE_CASES = [
    (2, 4, 2, 256, 256, 64, True, 0, "wgmma"),
    (1, 2, 2, 128, 384, 128, False, 0, "wgmma"),
    (1, 4, 1, 1, 512, 64, True, 511, "wgmma"),
    (2, 4, 4, 256, 256, 64, True, 0, "wgmma"),
    (1, 2, 2, 384, 384, 64, True, 0, "wgmma"),
    (4, 32, 8, 1024, 1024, 64, True, 0, "wgmma"),     # serving prefill
    (2, 28, 4, 333, 333, 128, True, 0, "wgmma"),      # group 7 (qwen2-vl-7b)
    (1, 56, 8, 200, 200, 128, True, 0, "wgmma"),      # group 7 (deepseek-coder-33b)
    (1, 8, 2, 100, 356, 64, True, 256, "wgmma"),      # a chunk at an offset
    (4, 32, 8, 1, 1056, 64, True, 1040, "splitkv"),   # serving decode
    (4, 32, 8, 1, 8192, 64, True, 8191, "splitkv"),   # an 8,192-key cache
    (2, 28, 4, 1, 1056, 128, True, 1000, "splitkv"),  # group 7 at D 128
    (1, 4, 1, 1, 512, 64, True, 511, "splitkv"),
    (2, 8, 2, 1, 300, 64, False, 0, "splitkv"),
    (1, 8, 2, 16, 200, 64, True, 150, "splitkv"),     # 64 rows
    (1, 4, 1, 1, 257, 80, True, 256, "splitkv"),
    (1, 8, 4, 2, 130, 96, True, 128, "splitkv"),
    (1, 4, 1, 1, 1056, 64, True, 10, "splitkv"),      # few live keys
    (2, 2, 2, 200, 200, 80, True, 0, "wgmma"),       # the padded tile
    (1, 8, 4, 130, 257, 96, True, 0, "wgmma"),
    (4, 16, 16, 1000, 1000, 80, False, 0, "wgmma"),   # hubert-xlarge, S 1000
    (1, 4, 2, 100, 356, 96, False, 0, "wgmma"),
]


def _bshd(case, dev):
    b, hq, hkv, sq, skv, d = case[:6]
    return [x.transpose(1, 2) for x in
            (torch.from_numpy(a).to(dev, BF16)
             for a in _qkv(b, hq, hkv, sq, skv, d, seed=b * 31 + sq + skv))]


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_each_route_matches_plain_version(card, case):
    causal, off, route = case[6:]
    q, k, v = _bshd(case, card)
    before = dict(fa.flash_attention_bshd.route_launches)
    got = fa._launch(route, q, k, v, causal, off,
                     fa.plan(q, k, causal, off)[1])
    want = fa.plain(q, k, v, causal, off)
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.route_launches[route] == before[route] + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    # Beside the reference's tolerance: each output row (a position and
    # head) within 2**-5 of its largest |value|, a few bf16 ulps.  A decode
    # step's outputs average over many keys and are about as small as 2e-2,
    # so only this limit sees a split or a key left out there.
    row_max = want.float().abs().amax(dim=-1, keepdim=True)
    assert bool(((got.float() - want.float()).abs() <= 2.0 ** -5 * row_max)
                .all())


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_route_counters_follow_the_plan(card, case):
    causal, off = case[6:8]
    q, k, v = _bshd(case, card)
    route, _splits = fa.plan(q, k, causal, off)
    before = dict(fa.flash_attention_bshd.route_launches)
    total = fa.flash_attention_bshd.launches
    fa.flash_attention_bshd(q, k, v, causal=causal, q_offset=off)
    after = fa.flash_attention_bshd.route_launches
    assert {r: after[r] - before[r] for r in fa.ROUTES} == {
        r: int(r == route) for r in fa.ROUTES}
    assert fa.flash_attention_bshd.launches == total + 1


def test_decode_is_deterministic(card):
    q, k, v = _bshd((4, 32, 8, 1, 1056, 64, True, 1040, "splitkv"), card)
    a = fa.flash_attention_bshd(q, k, v, causal=True, q_offset=1040)
    b = fa.flash_attention_bshd(q, k, v, causal=True, q_offset=1040)
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", [(2, 8, 2, 256, 256, 64, True, 0),
                                  (2, 8, 2, 1, 300, 64, True, 299)])
def test_bhsd_views_go_in_without_copies(card, case):
    b, hq, hkv, sq, skv, d, causal, off = case
    q, k, v = (torch.from_numpy(x).to(card, BF16)
               for x in _qkv(b, hq, hkv, sq, skv, d, seed=5))
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    swap = (lambda x: x.transpose(1, 2))
    want = swap(fa.plain(swap(q), swap(k), swap(v), causal, off))
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_misaligned_layouts_raise(card):
    q, k, v = _bshd((1, 8, 2, 100, 100, 64, True, 0, "wgmma"), card)
    wide = torch.zeros(1, 100, 8, 68, dtype=BF16, device=card)
    wide[..., :64] = q
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention_bshd(wide[..., :64], k, v)
    flat = torch.zeros(k.numel() + 1, dtype=BF16, device=card)
    shifted = flat[1:].view(k.shape)
    shifted.copy_(k)
    for route, qq in (("wgmma", q), ("splitkv", q[:, :1])):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa._launch(route, qq, shifted, v, True, 99, 1)
    flat32 = torch.zeros(k.numel() + 1, dtype=F32, device=card)
    shifted32 = flat32[1:].view(k.shape)
    shifted32.copy_(k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch("simt", q.float(), shifted32, v.float(), True, 99, 1)
    with pytest.raises(TypeError, match="simt route takes"):
        fa._launch("simt", q, k, v, True, 0, 1)
    with pytest.raises(ValueError, match="splitkv route holds"):
        fa._launch("splitkv", q, k, v, True, 0, 1)
    with pytest.raises(TypeError):
        fa._launch("wgmma", q.float(), k.float(), v.float(), True, 0, 1)
