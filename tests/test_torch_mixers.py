"""The port's MoE, MLA, Mamba and RWKV6 layers against the JAX package's.

Reduced configs on the CPU in float32, parameters drawn by the reference
and carried across (``params_from_reference``), inputs drawn with numpy
from a seed.  Tolerances are normwise (``max|port - ref| <= tol *
max|ref|``), as in ``test_torch_models.py``: 1e-5 for one layer, 1e-4 for
a stack; the MoE router's decisions (which (token, k) pairs an expert
keeps) are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as r_get_config
from repro.kernels import ref as r_ref
from repro.kernels import rwkv6_scan as r_rwkv6_scan
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.models import layers as RL
from repro.models import loss_fn as r_loss_fn
from repro.serve import prefill as r_prefill
from repro.serve import serve_step as r_serve_step
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import ref, rwkv6_scan
from repro_torch.models import init_cache, layers, loss_fn, params_from_reference
from repro_torch.models import transformer as T
from repro_torch.serve import prefill, serve_step
from repro_torch.tree import leaves, leaves_with_path, unflatten

BLOCK_TOL, STACK_TOL = 1e-5, 1e-4
#: Decode against the reference; see test_torch_models.py's docstring.
DECODE_TOL = {"rwkv6-3b": 5e-4, "jamba-v0.1-52b": 5e-4}


def _close(got, want, tol, msg=""):
    """Normwise: max |got - want| <= tol * max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"{msg}: max abs err {err} > {tol} x {scale}"


def _carry(arch, seed=3, **moe):
    """(reference cfg, port cfg, reference params, port params) for the
    reduced ``arch``, its MoE fields replaced by ``moe``."""
    r_cfg, cfg = r_get_config(arch).reduced(), get_config(arch).reduced()
    if moe:
        r_cfg = dataclasses.replace(r_cfg, moe=dataclasses.replace(r_cfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    rp = r_init_params(jax.random.PRNGKey(seed), r_cfg)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, device="cpu")
    return r_cfg, cfg, rp, tp


def _block(rp, tp, j=0):
    """Pattern position ``j``'s first layer: (reference, port) params."""
    return (jax.tree.map(lambda a: a[0], rp["blocks"][f"pos{j}"]),
            T._layer(tp["blocks"][f"pos{j}"], 0))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _r_flat(tree):
    return {tuple(p.key for p in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _reference_routing(cfg, p, x):
    """The reference's routing, step for step (``src/repro/models/
    layers.py``, ``apply_moe``): each pair's expert, whether it is kept,
    and the capacity."""
    m = cfg.moe
    b, s, _ = x.shape
    logits = jnp.einsum("bsd,de->bse", x, p["router"])
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, -1), m.top_k)
    cap = int(m.capacity_factor * m.top_k * s / m.n_routed)
    cap = max(cap, min(8, s * m.top_k))
    expert = gate_idx.reshape(b, s * m.top_k)
    onehot = jax.nn.one_hot(expert, m.n_routed, dtype=jnp.float32)
    rank = jnp.einsum("bte,bte->bt", jnp.cumsum(onehot, axis=1) - onehot,
                      onehot).astype(jnp.int32)
    return np.asarray(expert), np.asarray(rank < cap), cap


@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_moe_drops_the_references_pairs(cf):
    """At a capacity factor low enough that experts overflow, the port
    keeps exactly the reference's (token, k) pairs, and the layer's output
    and Switch aux loss agree."""
    r_cfg, cfg, rp, tp = _carry("qwen2-moe-a2.7b", capacity_factor=cf)
    rb, tb = _block(rp, tp)
    x = _normal((2, 64, cfg.d_model), seed=4)
    expert, keep, cap = _reference_routing(r_cfg, rb["mlp"], jnp.asarray(x))
    route = layers.moe_route(cfg, tb["mlp"], torch.from_numpy(x))
    assert route.cap == cap
    np.testing.assert_array_equal(route.expert.numpy(), expert)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    assert 0 < (~keep).sum() < keep.size          # drops occur, not all
    assert (route.slot.numpy() < cap).all()

    want, want_aux = RL.apply_moe(r_cfg, rb["mlp"], jnp.asarray(x))
    got, aux = layers.apply_moe(cfg, tb["mlp"], torch.from_numpy(x))
    _close(got, want, BLOCK_TOL)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


def test_moe_decode_step_drops_nothing():
    """One token a sequence: the capacity floor min(8, top_k) holds every
    choice."""
    _r_cfg, cfg, rp, tp = _carry("qwen2-moe-a2.7b", capacity_factor=1.25)
    route = layers.moe_route(cfg, _block(rp, tp)[1]["mlp"],
                             torch.from_numpy(_normal((4, 1, cfg.d_model), 5)))
    assert route.cap == cfg.moe.top_k and bool(route.keep.all())


def test_loss_fn_with_aux_and_grads_match_reference():
    """qwen2-moe reduced: loss (cross entropy + the MoE aux) within 1e-5,
    the aux within 1e-6, every gradient leaf within 1e-4 of its scale."""
    r_cfg, cfg, rp, tp = _carry("qwen2-moe-a2.7b", seed=5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 17), dtype=np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (r_loss, r_m), r_g = jax.value_and_grad(
        lambda p: r_loss_fn(r_cfg, p, {k: jnp.asarray(v) for k, v in
                                       batch.items()}), has_aux=True)(rp)
    leaf = [t.detach().requires_grad_(True) for t in leaves(tp)]
    loss, m = loss_fn(cfg, unflatten(tp, leaf),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(leaves_with_path(unflatten(tp, torch.autograd.grad(loss, leaf))))
    loss, m = loss.detach(), {k: v.detach() for k, v in m.items()}
    assert float(r_m["aux"]) > 0
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    assert abs(float(m["aux"]) - float(r_m["aux"])) <= 1e-6 * float(r_m["aux"])
    want = _r_flat(r_g)
    assert grads.keys() == want.keys()
    for path, g in grads.items():
        _close(g, want[path], STACK_TOL, "/".join(path))


# ---------------------------------------------------------------------------
# RWKV6 oracle and the chunked scans
# ---------------------------------------------------------------------------

def _naive_rwkv(r, k, v, w, u, s):
    """tests/test_kernels.py::test_rwkv6_ref_matches_naive_loop's loop."""
    T_ = r.shape[2]
    outs = np.zeros(r.shape[:3] + (v.shape[-1],), np.float32)
    for t in range(T_):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs[:, :, t] = np.einsum("bhk,bhkv->bhv", r[:, :, t],
                                  s + u[None, :, :, None] * kv)
        s = w[:, :, t, :, None] * s + kv
    return outs, s


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_oracle_matches_reference_and_naive_loop(with_state):
    B, H, T_, K = 1, 2, 7, 4
    rng = np.random.default_rng(0)
    r, k, v = (rng.normal(size=(B, H, T_, K)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, (B, H, T_, K)).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, K, K)).astype(np.float32) if with_state
          else np.zeros((B, H, K, K), np.float32))
    state = s0 if with_state else None
    want, want_s = r_ref.rwkv6_ref(*map(jnp.asarray, (r, k, v, w, u)),
                                   None if state is None else jnp.asarray(state))
    naive, naive_s = _naive_rwkv(r, k, v, w, u, s0)
    targs = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    tstate = None if state is None else torch.from_numpy(state)
    for fn in (ref.rwkv6_ref, rwkv6_scan):
        out, s_fin = fn(*targs, tstate)
        for got, a, b in ((out, want, naive), (s_fin, want_s, naive_s)):
            np.testing.assert_allclose(got.numpy(), np.asarray(a),
                                       rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got.numpy(), b, rtol=2e-5, atol=2e-5)
    out_r, s_r = r_rwkv6_scan(*map(jnp.asarray, (r, k, v, w, u)))
    np.testing.assert_allclose(rwkv6_scan(*targs)[0].numpy(), np.asarray(out_r),
                               rtol=2e-5, atol=2e-5)


def test_chunk_scans_match_reference():
    """``_mamba_chunk_scan`` (the reference's associative scan, here a
    plain scan) and ``_rwkv_chunk`` over three chunks, fp32."""
    B, T_, D, S_ = 2, 24, 6, 4
    a = np.random.default_rng(1).uniform(0.3, 1.0, (B, T_, D, S_)).astype(np.float32)
    bx, c = _normal((B, T_, D, S_), 2), _normal((B, T_, S_), 3)
    want_y, want_h = RL._mamba_chunk_scan(*map(jnp.asarray, (a, bx, c)), 8)
    got_y, got_h = layers._mamba_chunk_scan(*map(torch.from_numpy, (a, bx, c)), 8)
    _close(got_y, want_y, BLOCK_TOL)
    _close(got_h, want_h, BLOCK_TOL)

    H, K = 3, 8
    r, k, v = (_normal((B, H, T_, K), 4 + i) for i in range(3))
    logw = -np.exp(_normal((B, H, T_, K), 7, 0.5))
    u = _normal((H, K), 8)
    want_o, want_s = RL._rwkv_chunk(*map(jnp.asarray, (r, k, v, logw, u)), 8)
    got_o, got_s = layers._rwkv_chunk(*map(torch.from_numpy, (r, k, v, logw, u)), 8)
    _close(got_o, want_o, BLOCK_TOL)
    _close(got_s, want_s, BLOCK_TOL)


LENGTHS = [19, 8, 3]


def _prefill_both(arch, s, apply_r, apply_t):
    """One layer (pattern position 0) of the reduced ``arch`` in prefill
    mode on the same unit-scale input (a norm's output): (reference,
    port) outputs and caches."""
    r_cfg, cfg, rp, tp = _carry(arch)
    rb, tb = _block(rp, tp)
    h = _normal((2, s, cfg.d_model), seed=s)
    return (apply_r(r_cfg, rb["mixer"], jnp.asarray(h), mode="prefill"),
            apply_t(cfg, tb["mixer"], torch.from_numpy(h), mode="prefill"))


def _check_layer(want, got, tol):
    (want, want_c), (got, got_c) = want, got
    _close(got, want, tol)
    assert got_c.keys() == want_c.keys()
    for key in want_c:
        _close(got_c[key], want_c[key], tol, key)


@pytest.mark.parametrize("s", LENGTHS)
def test_mamba_at_lengths_off_the_chunk(s):
    """jamba's Mamba layer at lengths that are no multiple of the chunk (8
    in the reduced config; the tail padded with identity steps), and at one
    shorter than a chunk: output and prefill caches."""
    _check_layer(*_prefill_both("jamba-v0.1-52b", s, RL.apply_mamba,
                                layers.apply_mamba), BLOCK_TOL)


@pytest.mark.parametrize("s", LENGTHS)
def test_rwkv6_at_lengths_off_the_chunk(monkeypatch, s):
    """rwkv6's time-mix layer at the same lengths.  Its chunk is the
    reference's formula, whose fp32 rounding is set by the cumulative log
    decays: at unit-scale inputs they reach thousands (single steps of
    thousands), so ``exp(cum_t - cum_tau)`` keeps ~1e-5 of rounding in
    either package.  On this call's own chunk inputs the port's chunk is
    held to a float64 evaluation no further than twice the reference's
    chunk is, and the layer to the reference within four times that
    distance (at least 1e-5)."""
    seen = []
    chunk = layers._rwkv_chunk

    def spy(*args):
        seen.append(args)
        return chunk(*args)

    monkeypatch.setattr(layers, "_rwkv_chunk", spy)
    want, got = _prefill_both("rwkv6-3b", s, RL.apply_rwkv6, layers.apply_rwkv6)
    (args,) = seen
    exact = chunk(*(a.double() for a in args[:5]), args[5])
    port = chunk(*args)
    ref_ = RL._rwkv_chunk(*(jnp.asarray(a.numpy()) for a in args[:5]), args[5])

    def dist(pair):
        return max(float((torch.tensor(np.asarray(x)).double() - e).abs().max())
                   / float(e.abs().max()) for x, e in zip(pair, exact))

    assert dist(port) <= 2 * dist(ref_) + 1e-7
    _check_layer(want, got, max(BLOCK_TOL, 4 * dist(ref_)))


def test_softplus_is_jaxs():
    """F.softplus's linear branch above 20 (its default threshold) equals
    jax.nn.softplus (logaddexp(x, 0)) in fp32, and below it the two agree
    to an ulp or so."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        _normal((4000,), 9, 15.0)]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = F.softplus(torch.from_numpy(x)).numpy()
    above = x > 20
    np.testing.assert_array_equal(got[above], want[above])
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-30)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_absorbed_mla_decode_matches_reference():
    """One decode step of deepseek's MLA layer against a filled latent
    cache: output and both caches (written in place in the port)."""
    r_cfg, cfg, rp, tp = _carry("deepseek-v2-lite-16b")
    rb, tb = _block(rp, tp)
    m, pos, t = cfg.mla, 9, 16
    cache = {"ckv": _normal((2, t, m.kv_lora_rank), 10),
             "krope": _normal((2, t, m.qk_rope_dim), 11)}
    x = _normal((2, 1, cfg.d_model), 12)
    spec = cfg.pattern[0]
    want, want_c = RL.apply_mla(r_cfg, rb["mixer"], jnp.asarray(x), None, spec,
                                mode="decode", pos=pos,
                                cache={k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, got_c = layers.apply_mla(cfg, tb["mixer"], torch.from_numpy(x), None,
                                  spec, mode="decode", pos=pos, cache=tcache)
    _close(got, want, BLOCK_TOL)
    for key in cache:
        assert got_c[key] is tcache[key]
        _close(tcache[key], want_c[key], BLOCK_TOL, key)


def test_flash_path_refuses_mla_naming_item_14():
    """MLA's prefill attends with Dk 192 != Dv 128 (reduced: 16 != 8).  The
    flash path refused it, naming Queue 1 item 14, until that item gave it
    a zero-padded V; it now takes the call (the plain version of the padded
    call is the unpadded one's) and refuses only what no kernel takes: a
    head dim past 256 and a logit softcap."""
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
    with torch.no_grad():
        got = layers._flash(q, q, v, causal=True, q_offset=0, softcap=0.0)
    torch.testing.assert_close(got, layers._sdpa(q, q, v, causal=True),
                               rtol=1e-5, atol=1e-5)
    wide = torch.zeros((1, 4, 2, 320))
    with torch.no_grad(), pytest.raises(NotImplementedError, match="256"):
        layers._flash(wide, wide, wide, causal=True, q_offset=0, softcap=0.0)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="softcap"):
        layers._flash(q, q, v, causal=True, q_offset=0, softcap=30.0)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_dtypes_are_the_references(arch):
    """Recurrent states (Mamba ``ssm``, RWKV ``state``) in fp32, every other
    leaf in the activation dtype (bf16 here)."""
    r_cfg = dataclasses.replace(r_get_config(arch).reduced(),
                                act_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(), act_dtype="bfloat16")
    want = {p: str(x.dtype) for p, x in _r_flat(r_init_cache(r_cfg, 2, 12)).items()}
    got = {p: str(t.dtype).replace("torch.", "")
           for p, t in leaves_with_path(init_cache(cfg, 2, 12, device="cpu"))}
    assert got == want
    for path, dtype in got.items():
        assert dtype == ("float32" if path[-1] in ("ssm", "state")
                         else "bfloat16")


def test_per_layer_draws_stacked_leaves_at_their_layers_fan_in():
    """``init_params(per_layer=True)``: a stacked leaf's draws are the
    default draws rescaled from the layer count's fan-in to the layer's own
    (its second axis); every other leaf is the default draw."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    a = dict(leaves_with_path(T.init_params(torch.Generator().manual_seed(0), cfg)))
    b = dict(leaves_with_path(T.init_params(torch.Generator().manual_seed(0), cfg,
                                            per_layer=True)))
    rescaled = 0
    for path, t in a.items():
        spec = dict(leaves_with_path(T.model_schema(cfg)))[path]
        if path[0] == "blocks" and spec.init not in ("zeros", "ones"):
            f = (t.shape[0] / t.shape[1]) ** 0.5
            torch.testing.assert_close(b[path], t * f, rtol=1e-6, atol=0)
            rescaled += 1
        else:
            assert torch.equal(b[path], t), path
    assert rescaled > 10
    w = b[("blocks", "pos0", "mixer", "in_proj")]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "rwkv6-3b", "qwen2-moe-a2.7b"])
def test_three_decode_steps_write_the_stacked_caches_in_place(arch):
    """Decode writes every cache leaf (MLA latents, Mamba conv / ssm, RWKV
    state and shifts, K/V) into the tensors it was given, which are views of
    the stacked caches: the same tensors, and after three steps the
    reference's caches and logits.  A layer that bound a new tensor to a
    local name would leave the stack one step behind."""
    r_cfg, cfg, rp, tp = _carry(arch)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 3)).astype(np.int32)
    tol = DECODE_TOL.get(arch, STACK_TOL)

    _lg, caches, pos = prefill(cfg, tp, torch.from_numpy(toks), max_len=16)
    _r_lg, r_caches, r_pos = r_prefill(r_cfg, rp, jnp.asarray(toks), max_len=16)
    before = {p: (t, t.data_ptr()) for p, t in leaves_with_path(caches)}
    for j in range(3):
        lg, out = serve_step(cfg, tp, caches, torch.from_numpy(nxt[:, j:j + 1]),
                             pos + j)
        assert out is caches
        r_lg, r_caches = r_serve_step(r_cfg, rp, r_caches,
                                      jnp.asarray(nxt[:, j:j + 1]), r_pos + j)
        _close(lg, r_lg, tol, f"step {j}")
    after = dict(leaves_with_path(caches))
    want = _r_flat(r_caches)
    assert after.keys() == want.keys() == before.keys()
    for path, t in after.items():
        assert t is before[path][0] and t.data_ptr() == before[path][1]
        _close(t, want[path], tol, "/".join(path))
