"""The MLA decode kernels (``csrc/mla_decode.cu``) on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper
card and skips itself without one.  The file imports only the port (no JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_mla_decode_cuda.py

- The kernel pair against the plain version (``mla_decode.plain``) at
  deepseek-v2-lite-16b's full width (16 heads, R 512, rope 64), B 4, bf16,
  16,385 keys of a 16,448-row cache, with a few planted keys that dominate
  their heads: the last key read, a key in a middle split, and the row
  just past ``kv_len``.  Both round p to bf16 (the kernel before the
  softmax's division, the plain version after it) and o once, so they
  differ within 2**-7 of o's largest value.  Controls that must fail the
  same tolerance: the plain version one key short, one key long, and with
  one split's keys left out.
- Split plans from one split to one a tile agree within the tolerance;
  two calls give the same bits.
- A served request (``launch.serve.serve``) of a small model at
  deepseek's MLA widths launches the pair once an MLA layer in each decode
  forward and not in prefill; its MLA layer's decode output matches the
  path ``fits`` refuses (the query absorbed in fp32, the plain version)
  within bf16 rounding.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import MLACfg, get_config
from repro_torch.kernels import mla_decode
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params, layers
from repro_torch.serve.kv_tier import KVTierManager

pytestmark = pytest.mark.cuda

B, H, R, DR = 4, 16, 512, 64
MAX_LEN, KV_LEN = 16448, 16385
SCALE = 192 ** -0.5 * 1.5896
TOL = 2.0 ** -7


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel is built "
                    "for sm_90a and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, seed=0, plant=None):
    """Queries and caches in bf16.  ``plant``: a key whose latent row is
    moved along its sequence's mean query, so that it takes nearly all of
    every head's softmax."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q_lat = torch.randn((B, 1, H, R), generator=g, device=dev)
    q_rope = torch.randn((B, 1, H, DR), generator=g, device=dev)
    ckv = torch.randn((B, MAX_LEN, R), generator=g, device=dev)
    krope = torch.randn((B, MAX_LEN, DR), generator=g, device=dev)
    if plant is not None:
        mean = q_lat[:, 0].mean(1)
        ckv[:, plant] += 60 * mean / mean.norm(dim=-1, keepdim=True)
    bf = torch.bfloat16
    return q_lat.to(bf), q_rope.to(bf), ckv.to(bf), krope.to(bf)


def _err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _call(inputs, kv_len=KV_LEN):
    before = mla_decode.launches
    got = mla_decode.mla_decode(*inputs, kv_len, SCALE)
    assert mla_decode.launches - before == 2
    assert got.shape == (B, 1, H, R) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    return got


def test_kernel_matches_plain_at_full_width_with_controls(card):
    splits, per = mla_decode.split_plan(B, KV_LEN, mla_decode._sm_count(0))
    lo = (splits // 2) * per * mla_decode.TILE
    hi = lo + per * mla_decode.TILE
    inputs = _inputs(card)
    assert _err(_call(inputs), mla_decode.plain(*inputs, KV_LEN, SCALE)) < TOL
    # Controls, each outside the tolerance: the plain version one key
    # short (the last key read planted), one key long (the row past
    # kv_len planted) and without a middle split (a key of it planted).
    for plant, control in (
            (KV_LEN - 1, lambda i: mla_decode.plain(*i, KV_LEN - 1, SCALE)),
            (KV_LEN, lambda i: mla_decode.plain(*i, KV_LEN + 1, SCALE)),
            (lo + 5, lambda i: _without(i, lo, hi))):
        inputs = _inputs(card, seed=plant, plant=plant)
        got = _call(inputs)
        assert _err(got, mla_decode.plain(*inputs, KV_LEN, SCALE)) < TOL
        assert _err(got, control(inputs)) > 4 * TOL, plant


def _without(inputs, lo, hi):
    """The plain version over keys [0, KV_LEN) less [lo, hi)."""
    q_lat, q_rope, ckv, krope = inputs
    idx = torch.cat([torch.arange(lo), torch.arange(hi, KV_LEN)]).to(ckv.device)
    return mla_decode.plain(q_lat, q_rope, ckv[:, idx], krope[:, idx],
                            len(idx), SCALE)


def test_split_plans_agree_and_repeat_bit_equal(card):
    q_lat, q_rope, ckv, krope = _inputs(card, seed=1)
    tiles = -(-5000 // mla_decode.TILE)
    plans = [(1, tiles), (tiles, 1), (7, -(-tiles // 7))]
    outs = [mla_decode._launch(q_lat, q_rope, ckv, krope, 5000, SCALE, s, p)
            for s, p in plans]
    want = mla_decode.plain(q_lat, q_rope, ckv, krope, 5000, SCALE)
    for o in outs:
        assert _err(o, want) < TOL
    again = mla_decode._launch(q_lat, q_rope, ckv, krope, 5000, SCALE,
                               *plans[2])
    assert torch.equal(again, outs[2])


def test_short_caches_and_fewer_heads(card):
    for kv_len, heads in ((1, 16), (63, 16), (64, 8), (65, 3), (200, 1)):
        q_lat, q_rope, ckv, krope = _inputs(card, seed=kv_len)
        q_lat, q_rope = q_lat[:, :, :heads], q_rope[:, :, :heads]
        got = mla_decode.mla_decode(q_lat, q_rope, ckv, krope, kv_len, SCALE)
        want = mla_decode.plain(q_lat, q_rope, ckv, krope, kv_len, SCALE)
        assert _err(got, want) < TOL, (kv_len, heads)


def _mla_model():
    """deepseek-v2-lite-16b's MLA widths (16 heads, R 512, nope 128, rope
    64, v 128) and YaRN in a two-layer model of d 256, bf16."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    return dataclasses.replace(
        cfg, d_model=256, n_heads=16, n_kv_heads=16, head_dim=192,
        mla=MLACfg(kv_lora_rank=512, q_lora_rank=None, qk_nope_dim=128,
                   qk_rope_dim=64, v_head_dim=128),
        act_dtype="bfloat16", param_dtype="bfloat16")


def test_served_request_launches_once_a_layer_in_decode(card, monkeypatch):
    cfg = _mla_model()
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab, (2, 80),
                           generator=torch.Generator().manual_seed(1))
    gen = 6
    n_mla = sum(s.mixer == "mla" for s in cfg.layers())
    counts = []
    orig = launch_serve.serve_step

    def step(*a, **k):
        before = mla_decode.launches
        out = orig(*a, **k)
        counts.append(mla_decode.launches - before)
        return out

    orig_prefill = launch_serve.prefill

    def prefill(*a, **k):
        before = mla_decode.launches
        out = orig_prefill(*a, **k)
        counts.append(("prefill", mla_decode.launches - before))
        return out

    monkeypatch.setattr(launch_serve, "serve_step", step)
    monkeypatch.setattr(launch_serve, "prefill", prefill)
    with torch.no_grad():
        res = launch_serve.serve(cfg, params, [prompt, prompt], gen,
                                 KVTierManager(device=card), card)
    assert res["hit"] == [False, True]
    assert counts[0] == ("prefill", 0)
    assert counts[1:] == [2 * n_mla] * (2 * gen - 1)
    # One MLA layer's decode step on the kernel and on the path fits
    # refuses, against the same filled caches, agree within bf16 rounding.
    torch.manual_seed(2)
    x = torch.randn((2, 1, cfg.d_model), device=card, dtype=torch.bfloat16)
    p = params["prefix"]["layer0"]["mixer"]
    spec = cfg.prefix[0]
    caches = {"ckv": torch.randn((2, 86, 512), device=card).to(torch.bfloat16),
              "krope": torch.randn((2, 86, 64), device=card).to(torch.bfloat16)}
    with torch.no_grad():
        got, _ = layers.apply_mla(cfg, p, x, None, spec, mode="decode",
                                  cache={k: v.clone() for k, v in caches.items()},
                                  pos=80)
        monkeypatch.setattr(mla_decode, "fits", lambda *a, **k: False)
        want, _ = layers.apply_mla(cfg, p, x, None, spec, mode="decode",
                                   cache=caches, pos=80)
    assert _err(got, want) < 2 ** -6
