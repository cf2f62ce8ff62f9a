"""The MoE, MLA, Mamba and RWKV6 layers on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper
card and skips itself without one.  The file imports only the port (no JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_mixers_cuda.py

- The four reduced configs (qwen2-moe, deepseek-v2-lite, jamba, rwkv6) in
  f32 on the card against the port on the CPU from the same parameters and
  tokens: train and prefill logits, three decode steps' logits and the
  caches after them, each within 1e-4 of its scale (the CUDA scatter,
  ``topk``, ``cumsum`` and scans against the CPU's).  Their attention runs
  on ``simt`` (head dim 8 padded to 64); deepseek's MLA asks for the plain
  attention.
- MLA's train and prefill attention (Dk != Dv) on the card go through the
  ``wgmma`` kernel on a zero-padded V, and match the plain attention's
  run; deepseek-v2-lite-16b's own call (Dk 192, Dv 128) on ``wgmma``
  against the plain version.
- qwen2-moe-a2.7b's attention calls (B 4, 16 / 16 heads of 128, S 1024
  causal; a decode step at 1040 of a 1056-slot cache) on ``wgmma`` and
  ``splitkv`` against the plain version: 2e-2 and 2**-5 of each row's
  largest value, as the other routes' cases.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import forward, init_params, layers
from repro_torch.serve import grow_cache
from repro_torch.tree import leaves_with_path, tree_map

pytestmark = pytest.mark.cuda

MIXER_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
               "rwkv6-3b")


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel is built "
                    "for sm_90a and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(cfg, params, toks, plain):
    """Train and prefill logits, three decode steps, the caches after."""
    out = {}
    with torch.no_grad():
        out["train"] = forward(cfg, params, toks[:, :16], plain_attention=plain)[0]
        out["prefill"], caches, _ = forward(cfg, params, toks[:, :16],
                                            mode="prefill",
                                            plain_attention=plain)
        caches = grow_cache(cfg, caches, 24)
        for j in range(3):
            out[f"decode{j}"] = forward(cfg, params, toks[:, 16 + j:17 + j],
                                        mode="decode", caches=caches,
                                        pos=16 + j)[0]
    out.update({"/".join(p): t for p, t in leaves_with_path(caches)})
    return out


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_reduced_mixers_on_card_match_cpu(card, arch):
    cfg = get_config(arch).reduced()
    plain = cfg.mla is not None
    # per_layer: at one repeat the reference's fan-in (the layer count)
    # leaves std-1 weights, activations of ~1e9 and a stack that amplifies
    # any difference in rounding past the limit.
    p_cpu = init_params(torch.Generator().manual_seed(1), cfg, device="cpu",
                        per_layer=True)
    toks = torch.from_numpy(np.random.default_rng(len(arch)).integers(
        0, cfg.vocab, (2, 19)))
    fa.reset_launches()
    got = _run(cfg, tree_map(lambda t: t.to(card), p_cpu), toks.to(card), plain)
    routes = dict(fa.flash_attention_bshd.route_launches)
    want = _run(cfg, p_cpu, toks, plain)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key].cpu()
        assert g.dtype == w.dtype, key
        assert bool(torch.isfinite(g).all()), key
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), f"{key}: {err}"
    n_attn = sum(s.mixer in ("attn", "swa") for s in cfg.layers())
    assert routes == {"wgmma": 0, "splitkv": 0, "simt": 5 * n_attn}


def test_mla_prefill_on_card_needs_plain_attention(card):
    """MLA's train and prefill attention (reduced: Dk 16, Dv 8) on the card
    launch ``wgmma`` once per MLA layer in bf16 (96 query rows a KV head:
    no decode route; dense MLPs) and give the plain attention's logits within 2**-4 of
    their scale, bf16 through three layers.  (Before the padded V this
    call raised; ``plain_attention=True`` still asks for ``_sdpa``.)"""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    # dense MLPs in place of the MoE: a bf16 router's near-ties would flip
    # between the two runs and hide the attention's agreement
    cfg = dataclasses.replace(
        cfg, act_dtype="bfloat16", param_dtype="bfloat16",
        pattern=tuple(dataclasses.replace(s, mlp="swiglu")
                      for s in cfg.pattern))
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg,
                         per_layer=True)
    toks = torch.randint(0, cfg.vocab, (2, 96),
                         generator=torch.Generator().manual_seed(3)).to(card)
    n_mla = sum(s.mixer == "mla" for s in cfg.layers())
    with torch.no_grad():
        for mode in ("train", "prefill"):
            fa.reset_launches()
            logits = forward(cfg, params, toks, mode=mode)[0]
            routes = dict(fa.flash_attention_bshd.route_launches)
            plain = forward(cfg, params, toks, mode=mode,
                            plain_attention=True)[0]
            assert routes == {"wgmma": n_mla, "splitkv": 0, "simt": 0}
            assert bool(torch.isfinite(logits).all())
            err = float((logits.float() - plain.float()).abs().max())
            assert err <= 2.0 ** -4 * float(plain.float().abs().max())


def test_mla_call_at_full_width_on_wgmma(card):
    """deepseek-v2-lite-16b's prefill attention call (B 2, 16 heads, S 512,
    Dk 192, Dv 128) through ``layers._flash`` on the D 192 kernel, V
    zero-padded, against the plain version on the unpadded inputs."""
    rng = np.random.default_rng(192)
    q, k = (torch.from_numpy(rng.standard_normal((2, 512, 16, 192))
                             .astype(np.float32)).to(card, torch.bfloat16)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 512, 16, 128))
                         .astype(np.float32)).to(card, torch.bfloat16)
    fa.reset_launches()
    with torch.no_grad():
        got = layers._flash(q, k, v, causal=True, q_offset=0, softcap=0.0)
    want = layers._sdpa(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.route_launches["wgmma"] == 1
    assert got.shape == (2, 512, 16, 128)
    row_max = want.float().abs().amax(dim=-1, keepdim=True)
    assert bool(((got.float() - want.float()).abs()
                 <= 2e-2 + 2.0 ** -5 * row_max).all())


@pytest.mark.parametrize("case", [
    (4, 16, 16, 1024, 1024, 128, True, 0, "wgmma"),
    (4, 16, 16, 1, 1056, 128, True, 1040, "splitkv"),
], ids=["prefill-wgmma", "decode-splitkv"])
def test_qwen2_moe_attention_calls_on_their_routes(card, case):
    b, hq, hkv, sq, skv, d, causal, off, route = case
    rng = np.random.default_rng(b * 31 + sq + skv)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32)).to(card, torch.bfloat16)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    assert fa.plan(q, k, causal, off)[0] == route
    before = fa.flash_attention_bshd.route_launches[route]
    got = fa.flash_attention_bshd(q, k, v, causal=causal, q_offset=off)
    want = fa.plain(q, k, v, causal, off)
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.route_launches[route] == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    row_max = want.float().abs().amax(dim=-1, keepdim=True)
    assert bool(((got.float() - want.float()).abs() <= 2.0 ** -5 * row_max)
                .all())
