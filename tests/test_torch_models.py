"""The port's model stack against the JAX package's, on reduced configs.

Parameters are drawn by the reference (``init_params``), carried across as
numpy (``params_from_reference``), and both stacks run on the same numpy
inputs in float32.

Tolerances are normwise: ``max|port - ref| <= tol * max|ref|`` over a
tensor.  (Elementwise rtol is the wrong measure here: randomly initialised
blocks grow activations to hundreds, and an output element near 0 carries
the rounding of the large terms that cancelled into it.)  Block by block,
each block fed the same input, tol = 1e-5: the same arithmetic in float32.
The two frameworks' transcendentals differ in the last bits (XLA's CPU
``exp`` is not correctly rounded for about 9 % of float32 inputs, ATen's for
about 1 %), and a random stack amplifies that with depth: gemma3's reduced
stack grows its activations from ~15 to ~600 in one block.  Whole-stack
logits and caches are held at tol = 1e-4; the largest seen is gemma3's
logits at 1.9e-5 of their scale.  One cache is held at the stack's 1e-4
even block by block: the RWKV6 wkv state sums ``exp(cum_Q - cum_tau) k v``,
where the cumulative log decays reach a few hundred; XLA's cumsum (an
associative scan on the CPU) and torch's sequential one differ by an ulp
of that, ~1.5e-5, and exp turns it into that share of the state.

Two reduced configs are held at :data:`DECODE_TOL` after prefill + decode,
each for a cause in the reference itself: its own fp32 RWKV6 state after a
prefill sits about as far from a float64 evaluation of the same chunk
inputs as the port's does (``test_torch_mixers.py`` holds the port to
twice the reference's distance), and jamba's reduced stack grows its
activations to ~1e9, so that one ulp more in its embedding moves the
reference's own late ssm states by ~1e-4 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as R_ARCH_NAMES
from repro.configs import get_config as r_get_config
from repro.models import cache_schema as r_cache_schema
from repro.models import forward as r_forward
from repro.models import init_params as r_init_params
from repro.models import model_schema as r_model_schema
from repro.models import layers as r_layers
from repro.models import transformer as RT
from repro.serve import prefill as r_prefill
from repro.serve import serve_step as r_serve_step
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import (cache_schema, forward, init_cache, init_params,
                                layers, model_schema, params_from_reference)
from repro_torch.models import transformer as T
from repro_torch.serve import prefill, serve_step

#: Every config: attention / SWA / MLA / Mamba / RWKV6 mixers, dense and
#: MoE MLPs.
COVERED = ARCH_NAMES
DECODERS = tuple(a for a in COVERED if not get_config(a).encoder_only)
BLOCK_TOL, STACK_TOL = 1e-5, 1e-4
#: Decode logits and caches against the reference (see above).
DECODE_TOL = {"rwkv6-3b": 5e-4, "jamba-v0.1-52b": 5e-4}
B, S = 2, 16


def _close(got, want, tol, msg=""):
    """Normwise: max |got - want| <= tol * max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"{msg}: max abs err {err} > {tol} x {scale}"


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def carried():
    """{arch: (cfg, reference params, port params)} on the CPU."""
    out = {}
    for arch in COVERED:
        cfg = r_get_config(arch).reduced()
        rp = r_init_params(jax.random.PRNGKey(3), cfg)
        tree = jax.tree.map(np.asarray, rp)
        out[arch] = (cfg, rp, params_from_reference(tree, get_config(arch)
                                                    .reduced(), device="cpu"))
    return out


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        return rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_configs_are_the_references():
    assert ARCH_NAMES == R_ARCH_NAMES
    for arch in ARCH_NAMES:
        for cfg, rcfg in ((get_config(arch), r_get_config(arch)),
                          (get_config(arch).reduced(),
                           r_get_config(arch).reduced())):
            assert repr(cfg) == repr(rcfg)
            assert cfg.param_count() == rcfg.param_count()


@pytest.mark.parametrize("arch", COVERED)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_model_schema_matches_reference(arch, reduced):
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    rcfg = r_get_config(arch).reduced() if reduced else r_get_config(arch)
    ours = {p: (sp.shape, sp.axes, sp.init, sp.scale)
            for p, sp in _flat(model_schema(cfg))}
    theirs = {p: (sp.shape, sp.axes, sp.init, sp.scale)
              for p, sp in _flat(r_model_schema(rcfg))}
    assert ours == theirs
    cache = {p: sp.shape for p, sp in _flat(cache_schema(cfg, 2, 40))}
    want = {p: sp.shape for p, sp in _flat(r_cache_schema(rcfg, 2, 40))}
    assert cache == want


def test_carrying_parameters_checks_names_and_shapes(carried):
    cfg, rp, _ = carried["llama3.2-1b"]
    tree = jax.tree.map(np.asarray, rp)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, rp)
    tree["embed"]["w"] = tree["embed"]["w"][:-1]
    with pytest.raises(ValueError, match="embed/w"):
        params_from_reference(tree, cfg, device="cpu")


def test_bf16_parameters_carry_exactly():
    cfg = get_config("llama3.2-1b").reduced()
    rp = r_init_params(jax.random.PRNGKey(0),
                       r_get_config("llama3.2-1b").reduced())
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), rp)
    got = params_from_reference(tree, cfg, device="cpu", dtype=torch.bfloat16)
    for (path, t), (_, want) in zip(_flat(got), _flat(tree)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want, np.float32), path)


def test_init_params_follows_the_schema():
    cfg = get_config("gemma3-4b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg)
    shapes = {p: tuple(t.shape) for p, t in _flat(params)}
    assert shapes == {p: sp.shape for p, sp in _flat(model_schema(cfg))}
    again = init_params(torch.Generator().manual_seed(0), cfg)
    for (_, a), (_, b) in zip(_flat(params), _flat(again)):
        assert torch.equal(a, b)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for _, t in _flat(params))
    cache = init_cache(cfg, 2, 24, device="cpu")
    assert {p: tuple(t.shape) for p, t in _flat(cache)} == {
        p: sp.shape for p, sp in _flat(cache_schema(cfg, 2, 24))}


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", COVERED)
def test_forward_matches_reference(carried, arch, mode):
    cfg, rp, tp = carried[arch]
    x = _inputs(cfg, seed=len(arch))
    want, want_caches, want_aux = r_forward(cfg, rp, jnp.asarray(x), mode=mode)
    got, got_caches, aux = forward(cfg, tp, torch.from_numpy(x), mode=mode)
    _close(got, want, STACK_TOL)
    # the MoE layers' Switch loss; exactly 0 without MoE
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    if mode == "train":
        assert got_caches is None and want_caches is None
        return
    ours, theirs = dict(_flat(got_caches)), dict(_flat(want_caches))
    assert ours.keys() == theirs.keys()
    for path, t in ours.items():
        _close(t, theirs[path], STACK_TOL, str(path))


def _blocks(cfg, rp, tp):
    """(spec, reference block params, port block params), layer by layer."""
    out = [(spec, rp["prefix"][f"layer{i}"], tp["prefix"][f"layer{i}"])
           for i, spec in enumerate(cfg.prefix)]
    for rep in range(cfg.pattern_repeats()):
        for j, spec in enumerate(cfg.pattern):
            out.append((spec,
                        jax.tree.map(lambda a: a[rep], rp["blocks"][f"pos{j}"]),
                        T._layer(tp["blocks"][f"pos{j}"], rep)))
    return out


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", COVERED)
def test_each_block_matches_reference(carried, arch, mode):
    """Every block, fed the reference's input to that block, gives the
    reference's output (and prefill cache) within 1e-5 of its scale; so
    does the head, fed the reference's final hidden state."""
    cfg, rp, tp = carried[arch]
    x = _inputs(cfg, seed=len(arch))
    h_want, _, _ = r_forward(cfg, rp, jnp.asarray(x), return_hidden=True)
    _close(T._lm_head(cfg, tp, torch.tensor(np.asarray(h_want))),
           RT._lm_head(cfg, rp, h_want), BLOCK_TOL, "head")
    if cfg.frontend:
        h = jnp.einsum("bsf,fd->bsd", jnp.asarray(x), rp["frontend"]["proj"])
    else:
        h = rp["embed"]["w"][jnp.asarray(x)] * jnp.asarray(cfg.d_model ** 0.5,
                                                         jnp.float32)
    h = np.array(h)
    for i, (spec, rb, tb) in enumerate(_blocks(cfg, rp, tp)):
        want, want_cache, want_aux = RT._apply_block(
            cfg, spec, rb, jnp.asarray(h), None, mode, None, None)
        got, got_cache, aux = T._apply_block(cfg, spec, tb, torch.from_numpy(h),
                                             None, mode, None, None)
        _close(got, want, BLOCK_TOL, f"block {i}")
        assert (aux is None) == (spec.mlp != "moe")
        _close(torch.zeros(()) if aux is None else aux, want_aux, BLOCK_TOL,
               f"block {i} aux")
        for key in (want_cache or {}):
            tol = STACK_TOL if key == "state" else BLOCK_TOL   # see above
            _close(got_cache[key], want_cache[key], tol, f"block {i} {key}")
        h = np.array(want)


def test_mrope_position_streams_match_reference(carried):
    cfg, rp, tp = carried["qwen2-vl-7b"]
    x = _inputs(cfg, seed=5)
    rng = np.random.default_rng(6)
    pos3 = np.sort(rng.integers(0, 40, (3, B, S)), axis=-1).astype(np.int32)
    want, _, _ = r_forward(cfg, rp, jnp.asarray(x), positions=jnp.asarray(pos3))
    got, _, _ = forward(cfg, tp, torch.from_numpy(x),
                        positions=torch.from_numpy(pos3))
    _close(got, want, STACK_TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_full_forward(carried, arch):
    """The port's counterpart of tests/test_models_smoke.py's test, on the
    carried parameters, plus the reference's own decode logits."""
    cfg, rp, tp = carried[arch]
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    ext = np.concatenate([toks, nxt], 1)

    full, _, _ = forward(cfg, tp, torch.from_numpy(toks))
    lg, caches, pos = prefill(cfg, tp, torch.from_numpy(toks), max_len=S + 8)
    assert pos == S
    assert float((full[:, -1] - lg).abs().max()) < 2e-3
    full2, _, _ = forward(cfg, tp, torch.from_numpy(ext))
    lg2, caches = serve_step(cfg, tp, caches, torch.from_numpy(nxt), pos)
    assert float((full2[:, -1] - lg2).abs().max()) < 2e-3

    tol = DECODE_TOL.get(arch, STACK_TOL)
    r_lg, r_caches, r_pos = r_prefill(cfg, rp, jnp.asarray(toks), max_len=S + 8)
    _close(lg, r_lg, tol)
    r_lg2, r_caches = r_serve_step(cfg, rp, r_caches, jnp.asarray(nxt), r_pos)
    _close(lg2, r_lg2, tol)
    ours, theirs = dict(_flat(caches)), dict(_flat(r_caches))
    assert ours.keys() == theirs.keys()
    for path, t in ours.items():
        _close(t, theirs[path], tol, str(path))


def test_plain_attention_is_the_cpu_path(carried):
    """On the CPU both settings take the plain attention: the switch only
    matters on the card, where it holds the kernel path against it."""
    cfg, _, tp = carried["llama3.2-1b"]
    x = torch.from_numpy(_inputs(cfg, seed=2))
    a, _, _ = forward(cfg, tp, x)
    b, _, _ = forward(cfg, tp, x, plain_attention=True)
    assert torch.equal(a, b)


def test_sdpa_chunks_long_queries_like_the_reference():
    """The q-axis chunking of long prefills (s * t above the threshold)."""
    rng = np.random.default_rng(0)
    s = 4608                                   # 9 chunks of 512
    q = rng.standard_normal((1, s, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, s, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, s, 1, 8)).astype(np.float32)
    got = layers._sdpa(*(torch.from_numpy(a) for a in (q, k, v)), window=700)
    want = r_layers._sdpa(*(jnp.asarray(a) for a in (q, k, v)), window=700)
    _close(got, want, BLOCK_TOL)


@pytest.fixture
def kernel_path(monkeypatch):
    """The model's kernel path on the CPU: ``apply_attn`` and ``apply_mla``
    branch on ``x.is_cuda``; with it true they call ``layers._flash``,
    whose entry point computes the kernels' plain version on CPU tensors
    with the same padding, window and key count."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


ATTENTION_ARCHS = tuple(a for a in COVERED if any(
    s.mixer in ("attn", "swa", "mla") for s in get_config(a).layers()))


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_forward_on_the_kernel_path_matches_reference(carried, kernel_path,
                                                      arch, mode):
    """Every config's attention as the card calls the kernels (gemma3's
    windows, MLA's V zero-padded to Dk, head dim 8 padded to 64) gives the
    reference's logits and caches within 1e-4 of their scale."""
    cfg, rp, tp = carried[arch]
    x = _inputs(cfg, seed=len(arch))
    want, want_caches, _ = r_forward(cfg, rp, jnp.asarray(x), mode=mode)
    with torch.no_grad():
        got, got_caches, _ = forward(cfg, tp, torch.from_numpy(x), mode=mode)
    _close(got, want, STACK_TOL)
    for path, t in dict(_flat(got_caches or {})).items():
        _close(t, dict(_flat(want_caches))[path], STACK_TOL, str(path))


def test_mla_prefill_call_with_padded_v_matches_reference():
    """deepseek-v2-lite-16b's prefill attention call (16 heads, Dk 192 =
    128 + 64, Dv 128) on the kernel path: V zero-padded to 192, the D 192
    function at the scale 192**-0.5, the output cut to 128 columns -- the
    reference's ``_sdpa`` within 1e-5."""
    rng = np.random.default_rng(192)
    q, k = (rng.standard_normal((2, 40, 16, 192)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 40, 16, 128)).astype(np.float32)
    want = r_layers._sdpa(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    got = layers._flash(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=True, q_offset=0, softcap=0.0)
    assert got.shape == (2, 40, 16, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
