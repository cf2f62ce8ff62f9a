"""The port's serving path against the JAX package's, on the CPU.

Reduced llama3.2-1b (and, for the serve loop, reduced qwen2-moe-a2.7b and
rwkv6-3b) with the reference's parameters carried across
(``params_from_reference``), prompts drawn with numpy from a seed: the
greedy token streams must be equal, token for token.  The KV tier's
decisions (TTLs, tiers, moves, stats) must be equal under one injected
clock: the port's controller decides in float64 on the CPU, bit for bit as
the reference's numpy engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LayerSpec as RLayerSpec
from repro.configs import get_config as r_get_config
from repro.models import init_params as r_init_params
from repro.serve import greedy_generate as r_greedy_generate
from repro.serve import prefill as r_prefill
from repro.serve import serve_step as r_serve_step
from repro.serve.kv_tier import KVTierManager as RKVTierManager
from repro_torch.configs import ARCH_NAMES, LayerSpec, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as launch_serve
from repro_torch.models import params_from_reference
from repro_torch.serve import greedy_generate
from repro_torch.serve import prefill as t_prefill
from repro_torch.serve.kv_tier import KVTierManager

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def model():
    rcfg = r_get_config(ARCH).reduced()
    rp = r_init_params(jax.random.PRNGKey(0), rcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, rp),
                               get_config(ARCH).reduced(), device="cpu")
    return rcfg, rp, tp


@pytest.mark.parametrize("seed,batch,prompt_len,steps",
                         [(0, 2, 16, 12), (1, 3, 9, 20), (2, 1, 31, 8)])
def test_greedy_generate_matches_reference(model, seed, batch, prompt_len,
                                           steps):
    cfg, rp, tp = model
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    max_len = prompt_len + steps
    want = r_greedy_generate(cfg, rp, jnp.asarray(prompt), steps, max_len)
    got = greedy_generate(cfg, tp, torch.from_numpy(prompt), steps, max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _reference_serve(cfg, rp, prompts, gen):
    """The loop of ``repro.launch.serve.main`` on given prompts and
    parameters: token streams and hit flags per request."""
    tier = RKVTierManager(clock=lambda: 0.0)
    toks_out, hits = [], []
    for prompt in prompts:
        pkey = prompt.tobytes()
        blk = tier.lookup(pkey)
        p = jnp.asarray(prompt)
        if blk is None:
            logits, caches, pos = r_prefill(cfg, rp, p,
                                            max_len=prompt.shape[1] + gen)
            tier.insert(pkey, 1, payload=(caches, pos))
        else:
            caches, pos = blk.payload
            logits, caches = r_serve_step(cfg, rp, caches, p[:, -1:], pos - 1)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out = [tok]
        for _ in range(gen - 1):
            logits, caches = r_serve_step(cfg, rp, caches, tok, pos)
            pos = pos + 1
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out.append(tok)
        toks_out.append(np.asarray(jnp.concatenate(out, axis=1)))
        hits.append(blk is not None)
    return toks_out, hits


def test_serve_loop_matches_reference_and_reuses_prefixes(model):
    """The port's serving loop (prefix reuse through the tier, decode on a
    clone of the stored caches) gives the reference loop's tokens; a reused
    prefix gives the tokens its first request gave."""
    cfg, rp, tp = model
    args = launch_serve.build_parser().parse_args(
        ["--requests", "6", "--batch", "2", "--prompt-len", "24", "--gen", "10"])
    prompts = launch_serve.make_prompts(cfg, args)
    got = launch_serve.serve(cfg, tp, prompts, args.gen,
                             KVTierManager(device="cpu"), CPU)
    want, hits = _reference_serve(cfg, rp, [p.numpy().astype(np.int32)
                                            for p in prompts], args.gen)
    assert got["hit"] == hits == [False] * 3 + [True] * 3
    for g, w in zip(got["tokens"], want):
        np.testing.assert_array_equal(g.numpy(), w)
    for i in range(3):
        np.testing.assert_array_equal(got["tokens"][i].numpy(),
                                      got["tokens"][i + 3].numpy())
    assert got["decode_steps"] == [args.gen - 1] * 3 + [args.gen] * 3


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "rwkv6-3b"])
def test_serve_loop_matches_reference_with_moe_and_state_caches(arch):
    """The serving loop over MoE layers (qwen2-moe) and RWKV state caches
    (rwkv6) gives the reference loop's tokens, hits included.  A hit
    re-decodes the last prompt token at ``pos - 1``, as the reference does:
    a K/V cache takes that rewrite unchanged, but it advances a state cache
    a second time, and a prefill's MoE may drop pairs its decode keeps, so
    a hit's tokens need not equal its miss's.  They equal the reference's.
    """
    rcfg = r_get_config(arch).reduced()
    rp = r_init_params(jax.random.PRNGKey(0), rcfg)
    cfg = get_config(arch).reduced()
    tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, device="cpu")
    args = launch_serve.build_parser().parse_args(
        ["--arch", arch, "--requests", "6", "--batch", "2", "--prompt-len",
         "20", "--gen", "8"])
    prompts = launch_serve.make_prompts(cfg, args)
    got = launch_serve.serve(cfg, tp, prompts, args.gen,
                             KVTierManager(device="cpu"), CPU)
    want, hits = _reference_serve(rcfg, rp, [p.numpy().astype(np.int32)
                                             for p in prompts], args.gen)
    assert got["hit"] == hits == [False] * 3 + [True] * 3
    for g, w in zip(got["tokens"], want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_launch_serve_runs_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--reduced", "--requests", "4",
                       "--batch", "2", "--prompt-len", "12", "--gen", "5"])
    out = capsys.readouterr().out
    assert "req 3: hit=yes" in out and "req 2: hit=no" in out
    # decode_s times gen - 1 = 4 steps of batch 2 for each of 4 requests;
    # the 3 misses prefill.
    assert "decode: 32 tokens in" in out and "ms a step" in out
    assert "prefill: 3 prompts of 12 tokens in" in out and "'misses': 3" in out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launch_serve_accepts_every_config(arch, capsys):
    """Every reduced config serves on the CPU through the launcher (misses,
    then hits); the encoder-only one has no decode loop, as in the
    reference."""
    argv = ["--device", "cpu", "--arch", arch, "--requests", "4", "--batch",
            "2", "--prompt-len", "9", "--gen", "3"]
    if get_config(arch).encoder_only:
        with pytest.raises(SystemExit, match="encoder-only"):
            launch_serve.main(argv)
        return
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "req 3: hit=yes" in out and "decode: 16 tokens in" in out


def test_launch_serve_flags():
    parser = launch_serve.build_parser()
    assert parser.parse_args([]).reduced is True
    assert parser.parse_args(["--no-reduced"]).reduced is False
    assert parser.parse_args([]).device == "cuda"


def test_kv_tier_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVTierManager()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_tier_decides_as_the_reference(seed):
    """Inserts, lookups and scans on an injected clock, enough re-reads to
    pass the controller's warmup so TTLs come from the histograms: every
    TTL, tier, move and counter equals the reference's."""
    rng = np.random.default_rng(seed)
    now = [0.0]
    ref = RKVTierManager(clock=lambda: now[0], refresh_period=30.0)
    port = KVTierManager(clock=lambda: now[0], refresh_period=30.0,
                         device="cpu")
    keys = [f"p{i}" for i in range(12)]
    sizes = {k: int(rng.integers(1 << 16, 1 << 24)) for k in keys}
    for step in range(400):
        now[0] += float(rng.exponential(0.4))
        key = keys[int(rng.zipf(1.6)) % len(keys)]
        a, b = ref.lookup(key), port.lookup(key)
        assert (a is None) == (b is None)
        if a is None:
            a, b = ref.insert(key, sizes[key]), port.insert(key, sizes[key])
        assert (a.tier, a.ttl, a.last_access) == (b.tier, b.ttl, b.last_access)
        if step % 7 == 0:
            assert ref.scan() == port.scan()
    assert ref.stats == port.stats
    assert ref.occupancy() == port.occupancy()
    assert ref.stats["demotions"] > 0 and ref.stats["promotions"] > 0
    assert ref.ctl.edge_ttls.keys() == port.ctl.edge_ttls.keys() != set()
    for k, e in ref.ctl.edge_ttls.items():
        assert port.ctl.edge_ttls[k].ttl_seconds == e.ttl_seconds
    assert ref.t_even_seconds() == port.t_even_seconds()


def _gemma3_like(cfg, spec):
    """gemma3-4b's reduced config cut to 3 layers at its own head dim 256:
    two local layers (window 16), then one global; 2 / 1 heads."""
    local, glob = spec("swa", "swiglu", window=16), spec("attn", "swiglu")
    return dataclasses.replace(cfg, name="gemma3-like", n_layers=3,
                               head_dim=256, n_heads=2, n_kv_heads=1,
                               d_model=64, prefix=(local, local),
                               pattern=(glob,))


@pytest.fixture
def kernel_path(monkeypatch):
    """The model's kernel path on the CPU: ``apply_attn`` and ``apply_mla``
    branch on ``x.is_cuda``; with it true they call ``layers._flash``
    (head dims padded, the window in prefill, ``kv_len`` in decode), whose
    entry point computes the kernels' plain version on CPU tensors.  Counts
    the entry point's calls."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    calls = []
    entry = fa.flash_attention_bshd

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return entry(*args, **kwargs)

    monkeypatch.setattr("repro_torch.models.layers.flash_attention_bshd",
                        counted)
    return calls


@pytest.mark.parametrize("which", ["gemma3-like", "gemma3-4b"])
def test_serve_loop_matches_reference_on_the_kernel_path(which, kernel_path):
    """gemma3's local and global layers through the kernel path's calls: a
    40-token prompt (past the window: 16, reduced 8) and 6 generated
    tokens, so the ring caches wrap.  Prefill logits within 1e-4 of their
    scale of the reference's; the loop's greedy tokens and tier hits
    equal the reference loop's."""
    rcfg, cfg = r_get_config("gemma3-4b").reduced(), get_config("gemma3-4b").reduced()
    if which == "gemma3-like":
        rcfg, cfg = _gemma3_like(rcfg, RLayerSpec), _gemma3_like(cfg, LayerSpec)
    rp = r_init_params(jax.random.PRNGKey(0), rcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, device="cpu")
    args = launch_serve.build_parser().parse_args(
        ["--arch", "gemma3-4b", "--requests", "4", "--batch", "2",
         "--prompt-len", "40", "--gen", "6"])
    prompts = launch_serve.make_prompts(cfg, args)

    want, _, _ = r_prefill(rcfg, rp, jnp.asarray(prompts[0].numpy()),
                           max_len=46)
    with torch.no_grad():
        got, _, _ = t_prefill(cfg, tp, prompts[0], max_len=46)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= 1e-4 * float(np.abs(np.asarray(want)).max())
    windows = {c["window"] for c in kernel_path}
    assert windows == {None, 16 if which == "gemma3-like" else 8}

    with torch.no_grad():
        out = launch_serve.serve(cfg, tp, prompts, args.gen,
                                 KVTierManager(device="cpu"), CPU)
    ref_toks, hits = _reference_serve(rcfg, rp, [p.numpy().astype(np.int32)
                                                 for p in prompts], args.gen)
    assert out["hit"] == hits == [False] * 3 + [True]
    for g, w in zip(out["tokens"], ref_toks):
        np.testing.assert_array_equal(g.numpy(), w)
    decode_calls = [c for c in kernel_path if c["kv_len"] is not None]
    assert decode_calls and all(not c["causal"] for c in decode_calls)
