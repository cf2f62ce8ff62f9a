"""The routed MoE kernels (``csrc/moe_decode.cu``) on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper
card and skips itself without one.  The file imports only the port (no JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_moe_decode_cuda.py

- The kernel pair against the plain version (``moe_decode.plain``) at the
  full widths of qwen2-moe-a2.7b (60 experts of 1,408, top-4, a 4 x 1,408
  shared expert, d 2,048), deepseek-v2-lite-16b (64 of 1,408, top-6, 2
  shared) and jamba-v0.1-52b (16 of 14,336, top-2, no shared, d 4,096) at
  B 4, bf16: both end in one rounding of an fp32 sum, so they differ by
  the sums' order, within 2**-7 of the output's largest value (one bf16
  step); qwen2-moe in fp32 within 1e-5.  The gate / up kernel also at its
  narrow tile (32 columns).
- Forced routes: one expert chosen by every token, repeated experts, nine
  tokens (passes of 4, 4 and 1 in the gate / up kernel); tokens naming one
  expert in several pairs; ids outside the experts, which read nothing and
  give only their tokens NaN.
- Two calls give the same bits (fixed-order sums, no atomics).
- A served request (``launch.serve.serve``, reduced qwen2-moe at the full
  config's capacity factor) launches the pair once a MoE layer in each
  decode forward and not in prefill, whose spans show the capacity path.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels import moe_decode
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params
from repro_torch.serve.kv_tier import KVTierManager

pytestmark = pytest.mark.cuda

#: (arch, batch) at full width.
FULL = [("qwen2-moe-a2.7b", 4), ("deepseek-v2-lite-16b", 4),
        ("jamba-v0.1-52b", 4)]
BF16_TOL, F32_TOL = 2.0 ** -7, 1e-5


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel is built "
                    "for sm_90a and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(arch, dev, dtype, seed=0):
    """The MoE layer's expert weights at ``arch``'s full widths, std
    1 / sqrt(fan-in): (we_gate, we_up, we_down, ws_gate, ws_up, ws_down),
    the shared ones None without a shared expert."""
    cfg = get_config(arch)
    m, d = cfg.moe, cfg.d_model
    f = m.d_ff_expert or cfg.d_ff
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        return (torch.randn(shape, generator=g, device=dev)
                / math.sqrt(shape[-2])).to(dtype)

    shapes = [(m.n_routed, d, f), (m.n_routed, d, f), (m.n_routed, f, d)]
    if m.n_shared:
        shapes += [(d, m.n_shared * f), (d, m.n_shared * f),
                   (m.n_shared * f, d)]
    ws = [draw(*s) for s in shapes]
    return cfg, ws + [None] * (6 - len(ws))


def _routes(cfg, b, dev, seed=1):
    """Router-like routes: top-k of random probabilities, renormalised."""
    g = torch.Generator(device=dev).manual_seed(seed)
    probs = torch.softmax(torch.randn((b, cfg.moe.n_routed), generator=g,
                                      device=dev), -1)
    gates, expert = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return expert, gates / gates.sum(-1, keepdim=True)


def _x(cfg, b, dev, dtype, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((b, cfg.d_model), generator=g, device=dev).to(dtype)


def _err(got, want):
    return (float((got.float() - want.float()).abs().max())
            / float(want.float().abs().max()))


@pytest.mark.parametrize("arch,batch", FULL)
def test_kernels_match_plain_at_full_width(card, arch, batch):
    cfg, ws = _weights(arch, card, torch.bfloat16)
    expert, gates = _routes(cfg, batch, card)
    x = _x(cfg, batch, card, torch.bfloat16)
    with torch.no_grad():
        want = moe_decode.plain(x, expert, gates, *ws)
        before = moe_decode.launches
        got = moe_decode.routed_moe(x, expert, gates, *ws)
        torch.cuda.synchronize()
        assert moe_decode.launches == before + 2
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert bool(torch.isfinite(got).all())
        assert _err(got, want) <= BF16_TOL, _err(got, want)
        shared = tuple(ws[3:])
        forced = moe_decode._launch(x, expert, gates, *ws[:3], shared, 32)
        assert _err(forced, want) <= BF16_TOL
        torch.cuda.synchronize()


def test_kernels_match_plain_in_fp32(card):
    cfg, ws = _weights("qwen2-moe-a2.7b", card, torch.float32)
    expert, gates = _routes(cfg, 4, card)
    x = _x(cfg, 4, card, torch.float32)
    with torch.no_grad():
        want = moe_decode.plain(x, expert, gates, *ws)
        got = moe_decode.routed_moe(x, expert, gates, *ws)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _err(got, want) <= F32_TOL, _err(got, want)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b"])
def test_forced_routes_shared_and_repeated_experts(card, arch):
    """Nine tokens: expert 7 in every token's choices, expert 2 in the
    first five; the rest drawn from the remaining experts without
    repeats inside a token."""
    cfg, ws = _weights(arch, card, torch.bfloat16, seed=3)
    k, n_exp, b = cfg.moe.top_k, cfg.moe.n_routed, 9
    g = torch.Generator().manual_seed(4)
    rows = []
    for t in range(b):
        fixed = [7, 2] if t < 5 else [7]
        rest = [e for e in torch.randperm(n_exp, generator=g).tolist()
                if e not in fixed]
        rows.append((fixed + rest)[:k])
    expert = torch.tensor(rows, device=card)
    gates = torch.softmax(torch.randn((b, k), generator=g), -1).to(card)
    x = _x(cfg, b, card, torch.bfloat16, seed=5)
    with torch.no_grad():
        want = moe_decode.plain(x, expert, gates, *ws)
        got = moe_decode.routed_moe(x, expert, gates, *ws)
    torch.cuda.synchronize()
    assert _err(got, want) <= BF16_TOL, _err(got, want)


def test_a_token_naming_an_expert_twice(card):
    """Four tokens at qwen2-moe's full widths: one names expert 9 in all
    four pairs, one in three, one in two; each pair counts."""
    cfg, ws = _weights("qwen2-moe-a2.7b", card, torch.bfloat16, seed=6)
    expert = torch.tensor([[9, 9, 9, 9], [9, 1, 9, 9], [3, 9, 3, 9],
                           [0, 1, 2, 3]], device=card)
    g = torch.Generator().manual_seed(8)
    gates = torch.softmax(torch.randn((4, 4), generator=g), -1).to(card)
    x = _x(cfg, 4, card, torch.bfloat16, seed=9)
    with torch.no_grad():
        want = moe_decode.plain(x, expert, gates, *ws)
        got = moe_decode.routed_moe(x, expert, gates, *ws)
    torch.cuda.synchronize()
    assert _err(got, want) <= BF16_TOL, _err(got, want)


def test_ids_outside_the_experts_give_only_their_tokens_nan(card):
    """Ids E and -1 in tokens 1 and 2: their rows of y are NaN, the other
    tokens' rows are the plain version's on those tokens alone."""
    cfg, ws = _weights("qwen2-moe-a2.7b", card, torch.bfloat16)
    expert, gates = _routes(cfg, 4, card)
    expert[1, 2] = cfg.moe.n_routed
    expert[2, 0] = -1
    x = _x(cfg, 4, card, torch.bfloat16)
    keep = torch.tensor([0, 3], device=card)
    with torch.no_grad():
        got = moe_decode.routed_moe(x, expert, gates, *ws)
        want = moe_decode.plain(x[keep], expert[keep], gates[keep], *ws)
    torch.cuda.synchronize()
    assert bool(got[1:3].isnan().all())
    assert _err(got[keep], want) <= BF16_TOL, _err(got[keep], want)


def test_two_calls_give_the_same_bits(card):
    cfg, ws = _weights("qwen2-moe-a2.7b", card, torch.bfloat16)
    expert, gates = _routes(cfg, 4, card)
    x = _x(cfg, 4, card, torch.bfloat16)
    with torch.no_grad():
        a = moe_decode.routed_moe(x, expert, gates, *ws)
        b = moe_decode.routed_moe(x, expert, gates, *ws)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_served_request_launches_in_decode_only(card):
    """Reduced qwen2-moe in bf16 at capacity factor 1.25: prefill (S 12)
    may drop pairs and keeps the capacity path; every decode forward
    launches the pair once a MoE layer."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(
        cfg, act_dtype="bfloat16", param_dtype="bfloat16",
        moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg,
                         per_layer=True)
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab, (2, 12), generator=g)
               for _ in range(2)]
    n_moe = sum(s.mlp == "moe" for s in cfg.layers())
    tracing.reset()
    before = moe_decode.launches
    try:
        with torch.no_grad(), tracing.recording():
            out = launch_serve.serve(cfg, params, prompts, 4,
                                     KVTierManager(device="cuda"), card)
        torch.cuda.synchronize()
        buf = tracing.spans()
    finally:
        tracing.reset()
    steps = sum(out["decode_steps"])
    assert steps > 0 and out["hit"] == [False, False]
    assert moe_decode.launches - before == 2 * n_moe * steps
    children = {}
    for name, _a, _b, p in buf:
        if name.startswith("moe."):
            children.setdefault(p, (buf[buf[p][3]][0], set()))[1].add(name)
    assert len(children) == n_moe * (steps + len(prompts))
    for above, names in children.values():
        if above == "serve.decode_step":
            assert names == {"moe.route", "moe.routed", "moe.aux"}
        else:
            assert above == "serve.prefill" and "moe.routed" not in names
