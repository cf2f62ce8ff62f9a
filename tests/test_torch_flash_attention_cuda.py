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
Then head dims 192 and 256, the sliding window and the key count on every
route (``MASK_CASES``: gemma3-4b's, nemotron-4-340b's and deepseek's MLA
calls among them, windows of 1, 63-65, 129 keys and more, at an offset,
``kv_len`` below ``Skv``), decode at D 256 bit-equal on repeats, and the
model's windowed prefill, ring decode and multi-token decode steps
through the kernels.
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
from repro_torch.models import forward, init_params, layers
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
    bshd = [t.transpose(1, 2) for t in (q, k, v)]
    with pytest.raises(NotImplementedError, match="softcap"):
        layers._flash(*bshd, causal=True, q_offset=0, window=4, softcap=1.0)
    wide = torch.zeros(1, 8, 2, 320, device=card)
    with pytest.raises(NotImplementedError, match="at most 256"):
        layers._flash(wide, wide, wide, causal=True, q_offset=0, softcap=0.0)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bshd(*bshd, window=0)


def test_model_attention_goes_through_the_kernel(card):
    """On the card the model's prefill and decode attention launch the
    kernel once per layer call, the sliding-window layers (gemma3's
    reduced config at head dim 64) and a multi-token decode step too, and
    the logits follow the plain attention's."""
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
    swa_params = init_params(torch.Generator(device=card).manual_seed(1), swa,
                             per_layer=True)
    with torch.no_grad():
        want, _, _ = forward(swa, swa_params, toks, plain_attention=True)
        before = fa.flash_attention_bshd.launches
        got, caches, pos = prefill(swa, swa_params, toks, max_len=48)
        for step in (toks[:, :1], toks[:, 1:4]):   # one token, then three
            serve_step(swa, swa_params, caches, step, pos)
            pos += step.shape[1]
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.launches == before + 3 * swa.n_layers
    err = float((got.float() - want[:, -1].float()).abs().max())
    assert err <= 1e-4 * float(want.abs().max())


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


#: Head dims 192 / 256 and the masks on every route: (B, Hq, Hkv, Sq, Skv,
#: D, causal, q_offset, window, kv_len, route, dtype).  gemma3-4b's prefill
#: (window 1024 of S 2048) and ring decode (``kv_len`` = the filled slots),
#: a global layer's decode below ``Skv``, nemotron-4-340b's group of 12 at
#: D 192, an MLA-like prefill at D 192 and group 1, windows of 1, 63, 64,
#: 65, 129 keys and 1,024 at offsets, ``kv_len`` without a causal mask.
MASK_CASES = [
    (4, 8, 4, 2048, 2048, 256, True, 0, 1024, None, "wgmma", BF16),
    (1, 8, 4, 300, 300, 256, True, 0, 100, None, "wgmma", BF16),
    (2, 96, 8, 40, 40, 192, True, 0, None, None, "wgmma", BF16),
    (2, 16, 16, 300, 300, 192, True, 0, None, None, "wgmma", BF16),
    (1, 4, 2, 200, 333, 192, False, 0, None, 250, "wgmma", BF16),
    (1, 4, 2, 130, 400, 256, True, 270, 65, None, "wgmma", BF16),
    (1, 2, 1, 128, 128, 64, True, 0, 1, None, "wgmma", BF16),
    (1, 2, 1, 200, 200, 128, True, 0, 129, None, "wgmma", BF16),
    (1, 2, 2, 256, 256, 80, False, 0, 100, 200, "wgmma", BF16),
    (1, 4, 2, 333, 333, 256, True, 0, 64, None, "wgmma", BF16),
    (4, 8, 4, 1, 1024, 256, False, 1040, None, 1024, "splitkv", BF16),
    (4, 8, 4, 1, 1024, 256, False, 500, None, 501, "splitkv", BF16),
    (4, 8, 4, 1, 2080, 256, False, 2070, None, 2071, "splitkv", BF16),
    (2, 96, 8, 1, 1056, 192, True, 1040, None, None, "splitkv", BF16),
    (1, 8, 2, 16, 300, 256, True, 200, 70, None, "splitkv", BF16),
    (1, 4, 1, 1, 500, 192, True, 450, 63, None, "splitkv", BF16),
    (1, 64, 1, 1, 300, 256, True, 299, None, None, "splitkv", BF16),
    (1, 4, 1, 2, 300, 64, False, 0, None, 37, "splitkv", BF16),
    (1, 8, 4, 64, 64, 256, True, 0, 16, None, "simt", F32),
    (1, 4, 2, 100, 356, 192, True, 256, 50, None, "simt", F32),
    (1, 4, 4, 1, 200, 256, False, 150, None, 151, "simt", F32),
    (2, 4, 2, 40, 40, 64, True, 0, 9, None, "simt", F32),
    (1, 4, 1, 20, 90, 128, False, 0, 33, 80, "simt", F32),
]


def _mask_inputs(case, dev):
    b, hq, hkv, sq, skv, d = case[:6]
    return [x.transpose(1, 2) for x in
            (torch.from_numpy(a).to(dev, case[11])
             for a in _qkv(b, hq, hkv, sq, skv, d, seed=b * 31 + sq + skv + d))]


@pytest.mark.parametrize("case", MASK_CASES,
                         ids=lambda c: "-".join(map(str, c[:11])))
def test_masks_and_large_head_dims_on_each_route(card, case):
    """Each route forced against the plain version with the same masks:
    2e-5 in f32; 2e-2 and 2**-5 of each row's largest value in bf16.  The
    planner sends the case to the route it is forced on."""
    causal, off, window, kv_len, route, dtype = case[6:]
    q, k, v = _mask_inputs(case, card)
    masks = dict(window=window, kv_len=kv_len)
    assert fa.plan(q, k, causal, off, **masks)[0] == route
    before = dict(fa.flash_attention_bshd.route_launches)
    got = fa._launch(route, q, k, v, causal, off,
                     fa.plan(q, k, causal, off, **masks)[1], **masks)
    want = fa.plain(q, k, v, causal, off, **masks)
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.route_launches[route] == before[route] + 1
    assert bool(torch.isfinite(got).all())
    tol = 2e-5 if dtype == F32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == BF16:
        row_max = want.float().abs().amax(dim=-1, keepdim=True)
        assert bool(((got.float() - want.float()).abs()
                     <= 2.0 ** -5 * row_max).all())


@pytest.mark.parametrize("route,dtype", [("wgmma", BF16), ("splitkv", BF16),
                                         ("simt", F32)])
@pytest.mark.parametrize("window", [63, 64, 65])
def test_window_edge_moved_by_one_key_is_seen(card, route, dtype, window):
    """The window's edge is exact on every route: the result with window
    ``w`` equals the plain version at ``w`` and differs from it at
    ``w - 1`` and ``w + 1`` (one key more or fewer in rows past the
    edge)."""
    sq = 16 if route == "splitkv" else 200
    case = (1, 4, 2, sq, 300, 256, True, 300 - sq, window, None, route, dtype)
    q, k, v = _mask_inputs(case, card)
    off = case[7]
    got = fa._launch(route, q, k, v, True, off,
                     fa.plan(q, k, True, off, window=window)[1], window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == F32 else 2e-2
    for w in (window - 1, window, window + 1):
        want = fa.plain(q, k, v, True, off, window=w)
        close = bool(((got.float() - want.float()).abs()
                      <= tol + tol * want.float().abs()).all())
        assert close == (w == window), w


@pytest.mark.parametrize("case", [
    (4, 8, 4, 1, 1024, 256, False, 1040, None, 1024, "splitkv", BF16),
    (2, 96, 8, 1, 1056, 192, True, 1040, None, None, "splitkv", BF16)],
    ids=["gemma3-ring", "nemotron"])
def test_decode_at_large_head_dims_is_deterministic(card, case):
    causal, off, window, kv_len = case[6:10]
    q, k, v = _mask_inputs(case, card)
    a, b = (fa.flash_attention_bshd(q, k, v, causal=causal, q_offset=off,
                                    window=window, kv_len=kv_len)
            for _ in range(2))
    assert torch.equal(a, b)
