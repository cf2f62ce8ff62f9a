"""GQA decode's rope and cache write (``csrc/rope_cache.cu``) on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper
card and skips itself without one.  The file imports only the port (no JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_rope_cache_cuda.py

- The kernel against ``layers.rotate`` + ``write_seq`` on the card (the
  ops it replaces), at B 4 and the attention shapes of qwen2-moe-a2.7b,
  llama3.2-1b, gemma3-4b (a ring slot and a global layer), nemotron-4-340b
  and a YaRN table, at positions 0, 2,047 and 16,446, in bf16 and fp32:
  the rotated q and both caches bit for bit (the count of elements that
  differ is in the message).  Inputs at the strides the projections give
  and as strided views.
- Two controls that must fail the same comparison: the position one too
  high, and k written one slot late.
- A reduced qwen2-moe request served through ``launch.serve`` in bf16
  launches the kernel once an attention layer in each decode forward and
  never in prefill, with the tokens of a run whose ``fits`` refuses.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import write_seq
from repro_torch.kernels import rope_cache
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params, layers
from repro_torch.serve.kv_tier import KVTierManager

pytestmark = pytest.mark.cuda

#: (name, arch, Hq, Hkv, D, cache rows)
SHAPES = [
    ("qwen2-moe", "qwen2-moe-a2.7b", 16, 16, 128, 64),
    ("llama3.2-1b", "llama3.2-1b", 32, 8, 64, 64),
    ("gemma3-ring", "gemma3-4b", 8, 4, 256, 1024),
    ("gemma3-global", "gemma3-4b", 8, 4, 256, 48),
    ("nemotron", "nemotron-4-340b", 96, 8, 192, 32),
    ("yarn", "llama3.2-1b", 16, 4, 64, 32),
]
POSITIONS = (0, 2047, 16_446)
BATCH = 4


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel is built "
                    "for sm_90a and has no CPU mode")
    return torch.device("cuda")


def _cfg(arch, name):
    cfg = get_config(arch)
    if name == "yarn":
        yarn = dataclasses.replace(get_config("deepseek-v2-lite-16b").yarn,
                                   mscale=1.0)
        cfg = dataclasses.replace(cfg, rope_theta=10_000.0, yarn=yarn)
    return cfg


def _inputs(hq, hkv, d, rows, dtype, dev, seed=0):
    """q, k, v as the projections give them ([B, 1, H, D] views of one
    einsum output each) and the caches."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (draw(BATCH, 1, hq, d), draw(BATCH, 1, hkv, d),
            draw(BATCH, 1, hkv, d), draw(BATCH, rows, hkv, d),
            draw(BATCH, rows, hkv, d))


def _want(cfg, q, k, v, kc, vc, pos, slot):
    positions = (pos + torch.arange(1, device=q.device))[None, :].expand(
        q.shape[0], 1)
    q = layers.rotate(cfg, q, positions)
    k = layers.rotate(cfg, k, positions)
    write_seq(kc, slot, k.to(kc.dtype))
    write_seq(vc, slot, v.to(vc.dtype))
    return q


def _n_diff(a, b):
    """Elements whose bits differ (shape or dtype apart: all of them)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return a.numel()
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.contiguous().view(view) != b.contiguous().view(view)).sum())


def _run(cfg, d, inputs, pos, slot, want_pos=None, want_slot=None):
    """(differing elements of q, k_cache, v_cache) between the kernel at
    (pos, slot) and the replaced ops at (want_pos, want_slot)."""
    q, k, v, kc, vc = inputs
    kc_w, vc_w = kc.clone(), vc.clone()
    want = _want(cfg, q, k, v, kc_w, vc_w,
                 pos if want_pos is None else want_pos,
                 slot if want_slot is None else want_slot)
    inv, scale = layers._rope_table(d, cfg.rope_theta,
                                    getattr(cfg, "yarn", None), q.device)
    before = rope_cache.launches
    with torch.no_grad():
        got = rope_cache.rope_cache(q, k, v, kc, vc, pos, slot, inv, scale)
    torch.cuda.synchronize()
    assert rope_cache.launches == before + 1
    return _n_diff(got, want), _n_diff(kc, kc_w), _n_diff(vc, vc_w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_equals_rotate_and_write_seq(card, shape, dtype):
    name, arch, hq, hkv, d, rows = shape
    cfg = _cfg(arch, name)
    for i, pos in enumerate(POSITIONS):
        slot = pos % rows
        inputs = _inputs(hq, hkv, d, rows, dtype, card, seed=i)
        assert rope_cache.fits(cfg.rope, *inputs)
        diff = _run(cfg, d, inputs, pos, slot)
        assert diff == (0, 0, 0), (f"{name} pos {pos}: elements differing "
                                   f"in q, k_cache, v_cache: {diff} of "
                                   f"{inputs[0].numel()}, "
                                   f"{inputs[3].numel()}, {inputs[4].numel()}")


def test_strided_views(card):
    """q / k / v as views into one [B, 1, Hq + 2 Hkv, D] buffer and caches
    laid out [L, B, H, D] (every stride other than the projections')."""
    cfg = get_config("llama3.2-1b")
    hq, hkv, d, rows = 32, 8, 64, 40
    g = torch.Generator(device=card).manual_seed(5)
    qkv = torch.randn((BATCH, 1, hq + 2 * hkv, d), generator=g,
                      device=card).to(torch.bfloat16)
    q, k, v = qkv.split([hq, hkv, hkv], dim=2)
    kc, vc = (torch.randn((rows, BATCH, hkv, d), generator=g, device=card)
              .to(torch.bfloat16).transpose(0, 1) for _ in range(2))
    assert rope_cache.fits(cfg.rope, q, k, v, kc, vc)
    assert _run(cfg, d, (q, k, v, kc, vc), 1234, 17) == (0, 0, 0)


@pytest.mark.parametrize("defect", ["position_one_high", "slot_one_late"])
def test_controls_fail_the_comparison(card, defect):
    cfg = get_config("qwen2-moe-a2.7b")
    hq, hkv, d, rows = 16, 16, 128, 64
    inputs = _inputs(hq, hkv, d, rows, torch.bfloat16, card, seed=9)
    pos, slot = 2047, 2047 % rows
    if defect == "position_one_high":
        dq, dk, dv = _run(cfg, d, inputs, pos + 1, slot, want_pos=pos)
        assert dq > 0 and dk > 0 and dv == 0
    else:
        dq, dk, dv = _run(cfg, d, inputs, pos, (slot + 1) % rows,
                          want_slot=slot)
        assert dq == 0 and dk > 0 and dv > 0


def test_served_request_launches_once_a_layer_in_decode(card, monkeypatch):
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              act_dtype="bfloat16", param_dtype="bfloat16")
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg,
                         per_layer=True)
    prompt = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    gen = 6
    n_attn = sum(s.mixer in ("attn", "swa") for s in cfg.layers())
    counts = []
    orig_step, orig_prefill = launch_serve.serve_step, launch_serve.prefill

    def step(*a, **k):
        before = rope_cache.launches
        out = orig_step(*a, **k)
        counts.append(rope_cache.launches - before)
        return out

    def prefill(*a, **k):
        before = rope_cache.launches
        out = orig_prefill(*a, **k)
        counts.append(("prefill", rope_cache.launches - before))
        return out

    monkeypatch.setattr(launch_serve, "serve_step", step)
    monkeypatch.setattr(launch_serve, "prefill", prefill)
    with torch.no_grad():
        got = launch_serve.serve(cfg, params, [prompt, prompt], gen,
                                 KVTierManager(device=card), card)
    assert got["hit"] == [False, True]
    assert counts == [("prefill", 0)] + [n_attn] * (2 * gen - 1)
    monkeypatch.setattr(rope_cache, "fits", lambda *a, **k: False)
    counts.clear()
    with torch.no_grad():
        want = launch_serve.serve(cfg, params, [prompt, prompt], gen,
                                  KVTierManager(device=card), card)
    assert counts == [("prefill", 0)] + [0] * (2 * gen - 1)
    for a, b in zip(got["tokens"], want["tokens"]):
        assert torch.equal(a, b)
