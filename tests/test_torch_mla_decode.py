"""MLA decode's plain version and YaRN rope on the CPU.

- ``kernels.mla_decode.plain`` (the kernels' arithmetic) against the
  absorbed einsum decode of ``models.layers.apply_mla`` at deepseek's
  widths (16 heads, R 512, rope 64), bf16 inputs: within bf16 rounding
  of p (the plain version rounds it, the einsum path does not).
- ``apply_mla``'s decode on its kernel path (the kernel entry runs its
  plain version on the CPU; the query absorbed in bf16) against the path
  the shapes ``fits`` refuses take (the query absorbed in fp32), the split
  plans the card would take, and ``fits``.
- YaRN's frequency table, cos / sin scale and softmax factor against
  their closed form (Hugging Face's ``DeepseekV2YarnRotaryEmbedding``),
  computed here in float64; the rotation at a position against the
  closed-form angles; configurations without YaRN rotate as before.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import MLACfg, YarnCfg, get_config
from repro_torch.kernels import mla_decode
from repro_torch.models import init_params, layers

H, R, DR, NOPE = 16, 512, 64, 128
YARN = YarnCfg(factor=40.0, original_max_position=4096, beta_fast=32.0,
               beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)


def _einsum_decode(q_lat, q_rope, ckv, krope, pos, scale):
    """``apply_mla``'s einsum decode: every slot in fp32, those past
    ``pos`` masked."""
    t = ckv.shape[1]
    ckv_f = ckv.float()
    logits = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv_f)
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             krope.float())) * scale
    logits = logits.masked_fill(~(torch.arange(t) <= pos), -1e30)
    return torch.einsum("bhst,btr->bshr", torch.softmax(logits, -1), ckv_f)


@pytest.mark.parametrize("b, t, pos", [(4, 40, 32), (2, 70, 0), (1, 64, 63)])
def test_plain_matches_the_einsum_decode(b, t, pos):
    g = torch.Generator().manual_seed(pos + t)
    bf = torch.bfloat16
    q_lat = torch.randn((b, 1, H, R), generator=g).to(bf)
    q_rope = torch.randn((b, 1, H, DR), generator=g).to(bf)
    ckv = torch.randn((b, t, R), generator=g).to(bf)
    krope = torch.randn((b, t, DR), generator=g).to(bf)
    scale = 192 ** -0.5 * layers.yarn_mscale(40.0, 0.707) ** 2
    got = mla_decode.plain(q_lat, q_rope, ckv, krope, pos + 1, scale)
    want = _einsum_decode(q_lat, q_rope, ckv, krope, pos, scale)
    assert got.shape == (b, 1, H, R) and got.dtype == bf
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err < 2 ** -7
    # The rows past kv_len are not read: changing them changes nothing.
    ckv2 = ckv.clone()
    ckv2[:, pos + 1:] = 1e4
    assert torch.equal(mla_decode.plain(q_lat, q_rope, ckv2, krope, pos + 1,
                                        scale), got)


def _mla_model():
    """deepseek's MLA widths and YaRN in a two-layer model of d 256, bf16."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    return dataclasses.replace(
        cfg, d_model=256, n_heads=16, n_kv_heads=16, head_dim=192,
        mla=MLACfg(kv_lora_rank=R, q_lora_rank=None, qk_nope_dim=NOPE,
                   qk_rope_dim=DR, v_head_dim=128),
        act_dtype="bfloat16", param_dtype="bfloat16")


def test_apply_mla_kernel_path_matches_the_einsum_path(monkeypatch):
    cfg = _mla_model()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    p = params["prefix"]["layer0"]["mixer"]
    g = torch.Generator().manual_seed(1)
    bf = torch.bfloat16
    x = torch.randn((2, 1, cfg.d_model), generator=g).to(bf)
    cache = {"ckv": torch.randn((2, 50, R), generator=g).to(bf),
             "krope": torch.randn((2, 50, DR), generator=g).to(bf)}
    calls = []
    orig = mla_decode.mla_decode

    def entry(*a):
        calls.append(a[4])
        return orig(*a)

    monkeypatch.setattr(mla_decode, "mla_decode", entry)
    with torch.no_grad():
        with monkeypatch.context() as refused:
            refused.setattr(mla_decode, "fits", lambda *a, **k: False)
            want, want_c = layers.apply_mla(
                cfg, p, x, None, cfg.prefix[0], mode="decode",
                cache={k: v.clone() for k, v in cache.items()}, pos=41)
        assert calls == []
        got, got_c = layers.apply_mla(cfg, p, x, None, cfg.prefix[0],
                                      mode="decode", cache=cache, pos=41)
    assert calls == [42]
    for k in ("ckv", "krope"):
        assert torch.equal(got_c[k], want_c[k])
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err < 2 ** -6


def test_fits_and_split_plans():
    bf = torch.bfloat16
    ckv, krope = torch.zeros((4, 100, R), dtype=bf), torch.zeros((4, 100, DR), dtype=bf)
    assert mla_decode.fits(4, 1, 16, ckv, krope, bf)
    assert not mla_decode.fits(4, 2, 16, ckv, krope, bf)          # two tokens
    assert not mla_decode.fits(4, 1, 17, ckv, krope, bf)          # 17 heads
    assert not mla_decode.fits(4, 1, 16, ckv, krope, torch.float32)
    assert not mla_decode.fits(4, 1, 16, ckv[..., :256], krope, bf)
    assert not mla_decode.fits(4, 1, 16, ckv[:, :, 1:], krope, bf)  # unaligned
    for b, kv_len in ((4, 16447), (4, 16385), (1, 1), (2, 31), (64, 5000)):
        splits, per = mla_decode.split_plan(b, kv_len, 132)
        tiles = -(-kv_len // mla_decode.TILE)
        assert splits * per >= tiles > (splits - 1) * per
        assert b * splits < mla_decode.BLOCKS_PER_SM * 132 + b


def _closed_form(dim, theta, y):
    """HF's YaRN frequencies in float64."""
    def corr(rot):
        return dim * math.log(y.original_max_position / (rot * 2 * math.pi)) / (
            2 * math.log(theta))
    low = max(math.floor(corr(y.beta_fast)), 0)
    high = min(math.ceil(corr(y.beta_slow)), dim - 1)
    i = np.arange(dim // 2, dtype=np.float64)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    extra = theta ** (-2 * i / dim)
    return extra / y.factor * ramp + extra * (1 - ramp), low, high


def test_yarn_table_and_scales_match_the_closed_form():
    inv = layers.yarn_inv_freq(DR, 10000.0, YARN)
    want, low, high = _closed_form(DR, 10000.0, YARN)
    assert (low, high) == (10, 23)
    np.testing.assert_allclose(inv.numpy(), want, rtol=2e-6)
    assert inv.dtype == torch.float32
    # The dims turning fast keep their frequency, the slow ones are
    # stretched by the factor.
    np.testing.assert_allclose(inv[:10].numpy(), 10000.0 ** (-np.arange(10) / 32),
                               rtol=2e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    cfg = get_config("deepseek-v2-lite-16b")
    assert cfg.yarn == YARN
    assert layers.softmax_factor(cfg) == pytest.approx(m * m, rel=1e-12)
    assert layers.softmax_factor(cfg) == pytest.approx(1.5896, abs=1e-4)
    assert layers.softmax_factor(get_config("qwen2-moe-a2.7b")) == 1.0
    _freq, cs = layers._rope_table(DR, 10000.0, YARN, torch.device("cpu"))
    assert cs == 1.0


def test_yarn_rotation_at_a_position():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 3, 2, DR), generator=g, dtype=torch.float64).float()
    pos = torch.tensor([[0, 4095, 16446]])
    got = layers.apply_rope(x, pos, 10000.0, YARN).double()
    inv, _, _ = _closed_form(DR, 10000.0, YARN)
    ang = pos[0].double().numpy()[:, None] * inv[None]
    cos, sin = np.cos(ang)[None, :, None], np.sin(ang)[None, :, None]
    x1, x2 = x.double().numpy()[..., :32], x.double().numpy()[..., 32:]
    want = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    # Without YaRN: the plain table, as before.
    plain = layers.apply_rope(x, pos, 10000.0)
    assert torch.equal(plain, layers.rotate(
        dataclasses.replace(get_config("deepseek-v2-lite-16b"), yarn=None), x, pos))


def test_prefill_softmax_scale_carries_the_yarn_factor(monkeypatch):
    """Prefill hands the attention ``Dk**-0.5 * softmax_factor``; without
    YaRN it hands no scale (the kernels' and _sdpa's own Dk**-0.5)."""
    seen = []
    orig = layers._sdpa

    def sdpa(*a, **k):
        seen.append(k.get("scale"))
        return orig(*a, **k)

    monkeypatch.setattr(layers, "_sdpa", sdpa)
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 5, cfg.d_model))
    p = params["prefix"]["layer0"]["mixer"]
    layers.apply_mla(cfg, p, x, None, cfg.prefix[0], mode="prefill")
    layers.apply_mla(dataclasses.replace(cfg, yarn=None), p, x, None,
                     cfg.prefix[0], mode="prefill")
    dk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
    assert seen[0] == pytest.approx(dk ** -0.5 * layers.softmax_factor(cfg))
    assert seen[1] is None
