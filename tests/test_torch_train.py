"""The port's training path against the JAX package's, on the CPU.

Inputs are drawn with numpy from seeds, carried to both packages as numpy,
and both run in float32 unless a case names bf16.  Tolerances:

- int8 gradient compression: the quantized values, the scales, the
  dequantized values and the error-feedback residuals bit-equal (the same
  float32 division, half-to-even rounding, clip and cast order);
- one AdamW / Adafactor update: each leaf within 1e-6 of its largest |value|
  (one bf16 ulp at that scale, 2**-7, for bf16 leaves): the same float32
  arithmetic, with only the frameworks' ``pow`` / ``rsqrt`` / ``sqrt``
  differing in the last bit;
- ``loss_fn`` (reduced llama3.2-1b): the loss within 1e-5 relative and each
  gradient leaf within 1e-4 of its largest |value|, at S 16 and at S 1024
  (the chunked lm-head path);
- ``make_train_step``: 3 steps, losses within 1e-5 relative and params
  within 1e-4 of each leaf's largest |value|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.distributed import compression as r_comp
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro.train import optimizer as r_opt
from repro.train import trainer as r_trainer
from repro_torch.configs import get_config
from repro_torch.distributed import compression
from repro_torch.models import (cross_entropy, loss_fn, params_from_reference)
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import (init_train_state, make_eval_step,
                               make_optimizer, make_train_step,
                               train_state_from_reference)

CPU = "cpu"
BF16_ULP = 2.0 ** -7


def to_torch(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def to_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def r_paths(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(p.key) for p in path)] = np.asarray(leaf)
    return out


def assert_trees(got, want, tol, bit_equal=False):
    """Every leaf of the port's tree ``got`` against the reference's
    ``want``: same paths, shapes and dtypes; max |got - want| <= tol x
    max |want| (or one bf16 ulp at that scale for bf16 leaves)."""
    g = dict(leaves_with_path(got))
    w = r_paths(want)
    assert set(g) == set(w)
    for path in sorted(w):
        a, b = g[path], w[path]
        assert tuple(a.shape) == b.shape, path
        bf16 = b.dtype == ml_dtypes.bfloat16
        assert (a.dtype == torch.bfloat16) == bf16, path
        a, b = to_numpy(a), b.astype(np.float32) if bf16 else b
        if bit_equal:
            np.testing.assert_array_equal(a, b, err_msg=str(path))
            continue
        err = float(np.abs(a.astype(np.float64) - b).max()) if b.size else 0.0
        scale = float(np.abs(b).max()) if b.size else 0.0
        limit = (BF16_ULP if bf16 else tol) * scale
        assert err <= limit, f"{path}: {err} > {limit}"


def seeded_tree(seed, dtype=np.float32, big=False):
    """A small parameter-like tree; ``big`` adds a 128 x 256 leaf, which
    Adafactor factors."""
    rng = np.random.default_rng(seed)
    tree = {"layer": {"w": rng.standard_normal((8, 12)),
                      "b": rng.standard_normal((12,)),
                      "stack": rng.standard_normal((2, 4, 6))},
            "embed": {"w": rng.standard_normal((16, 8)) * 3.0}}
    if big:
        tree["proj"] = {"w": rng.standard_normal((128, 256)) * 0.1}
    return jax.tree.map(lambda x: np.asarray(x).astype(dtype), tree)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compression_bit_equal(seed, dtype):
    npd = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    grads = seeded_tree(seed, npd)
    r_grads = jax.tree.map(jnp.asarray, grads)
    t_grads = tree_map(to_torch, grads)
    rq, rs = r_comp.compress_grads_int8(r_grads)
    tq, ts = compression.compress_grads_int8(t_grads)
    assert_trees(tq, rq, 0, bit_equal=True)
    assert_trees(ts, rs, 0, bit_equal=True)
    assert_trees(compression.decompress_grads_int8(tq, ts),
                 r_comp.decompress_grads_int8(rq, rs), 0, bit_equal=True)
    r_res, t_res = r_comp.init_residual(r_grads), compression.init_residual(t_grads)
    assert_trees(t_res, r_res, 0, bit_equal=True)
    for step in range(3):
        g = seeded_tree(100 + 10 * seed + step, npd)
        r_deq, r_res = r_comp.compress_with_error_feedback(
            jax.tree.map(jnp.asarray, g), r_res)
        t_deq, t_res = compression.compress_with_error_feedback(
            tree_map(to_torch, g), t_res)
        assert_trees(t_deq, r_deq, 0, bit_equal=True)
        assert_trees(t_res, r_res, 0, bit_equal=True)
    r_deq, _ = r_comp.compress_with_error_feedback(r_grads, None)
    t_deq, _ = compression.compress_with_error_feedback(t_grads, None)
    assert_trees(t_deq, r_deq, 0, bit_equal=True)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

#: (optimizer, param dtype, optimizer kwargs)
OPT_CASES = [
    ("adamw", "float32", {}),
    ("adamw", "bfloat16", {}),                                # auto master
    ("adamw", "bfloat16", {"use_master": False}),
    ("adamw", "float32", {"use_master": True, "moment_dtype": "bfloat16"}),
    ("adamw", "bfloat16", {"moment_dtype": "bfloat16"}),
    ("adafactor", "float32", {}),
    ("adafactor", "bfloat16", {}),
    ("adafactor", "bfloat16", {"use_master": False}),
]


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("name,pdtype,kw", OPT_CASES)
def test_optimizer_update_matches_reference(name, pdtype, kw, step):
    npd = np.float32 if pdtype == "float32" else ml_dtypes.bfloat16
    kw = dict(kw, lr=1e-2, warmup_steps=2)
    r_cfg, r_o = r_opt.make_optimizer(name, **kw)
    cfg, o = make_optimizer(name, **kw)
    params = jax.tree.map(jnp.asarray, seeded_tree(7, npd, big=True))
    state = r_o.init(params)
    for s in range(step):         # a state with history, from the reference
        g = jax.tree.map(jnp.asarray, seeded_tree(20 + s, npd, big=True))
        params, state = r_o.update(params, g, state, jnp.asarray(s, jnp.int32))
    grads = seeded_tree(50, npd, big=True)
    t_params = tree_map(to_torch, jax.tree.map(np.asarray, params))
    t_state = tree_map(to_torch, jax.tree.map(np.asarray, state))
    assert_trees(o.init(t_params), r_o.init(params), 0, bit_equal=True)
    assert_trees(t_state, state, 0, bit_equal=True)
    r_new, r_st = r_o.update(params, jax.tree.map(jnp.asarray, grads), state,
                             jnp.asarray(step, jnp.int32))
    t_new, t_st = o.update(t_params, tree_map(to_torch, grads), t_state,
                           torch.tensor(step, dtype=torch.int32))
    assert_trees(t_new, r_new, 1e-6)
    assert_trees(t_st, r_st, 1e-6)
    if step == 0:                 # lr 0 at step 0: params unchanged
        assert_trees(t_new, params, 0, bit_equal=True)


def test_adafactor_factors_the_wide_leaf_and_axes_match():
    params = seeded_tree(3, big=True)
    cfg, o = make_optimizer("adafactor")
    state = o.init(tree_map(to_torch, params))
    assert set(state["stats"]["proj"]["w"]) == {"vr", "vc"}
    assert set(state["stats"]["layer"]["w"]) == {"v"}
    axes = {"layer": {"w": ("a", "b"), "b": ("b",), "stack": ("l", "a", "b")},
            "embed": {"w": ("v", "d")}, "proj": {"w": ("x", "y")}}
    r_cfg, _ = r_opt.make_optimizer("adafactor")
    want = r_opt.opt_state_axes(r_cfg, params, axes)
    got = opt_mod.opt_state_axes(cfg, tree_map(to_torch, params), axes)
    assert got == want
    for name in ("adamw", "adafactor"):
        bf = jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16), params)
        r_cfg, _ = r_opt.make_optimizer(name)
        cfg, _ = make_optimizer(name)
        assert (opt_mod.opt_state_axes(cfg, tree_map(to_torch, bf), axes)
                == r_opt.opt_state_axes(r_cfg, bf, axes))


# ---------------------------------------------------------------------------
# loss_fn and the train step on reduced llama3.2-1b
# ---------------------------------------------------------------------------

ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params)."""
    r_cfg = r_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    rp = r_init_params(jax.random.PRNGKey(5), r_cfg)
    return r_cfg, cfg, rp, params_from_reference(jax.tree.map(np.asarray, rp),
                                                 cfg, device=CPU)


def batch_of(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1), dtype=np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def test_cross_entropy_matches_reference():
    from repro.models import cross_entropy as r_ce
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 33)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5), dtype=np.int32)
    want = float(r_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("s", [16, 1024])
def test_loss_fn_and_grads_match_reference(model, s):
    r_cfg, cfg, rp, tp = model
    batch = batch_of(cfg.vocab, 2, s, seed=s)
    (r_loss, r_m), r_g = jax.value_and_grad(
        lambda p: r_loss_fn(r_cfg, p, {k: jnp.asarray(v) for k, v in
                                       batch.items()}), has_aux=True)(rp)
    leaf = [p.detach().requires_grad_(True) for p in leaves(tp)]
    loss, m = loss_fn(cfg, unflatten(tp, leaf), {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    g_tree = unflatten(tp, torch.autograd.grad(loss, leaf))
    loss = loss.detach()
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    ce = float(m["ce"].detach())
    assert abs(ce - float(r_m["ce"])) <= 1e-5 * abs(float(r_m["ce"]))
    assert float(m["aux"]) == 0.0
    assert_trees(g_tree, r_g, 1e-4)


def test_chunked_loss_equals_unchunked_and_eval_step(model):
    """The chunked path is the same function: S 1024 chunked equals the
    plain head + cross_entropy on the full logits; the eval step (no grad)
    gives the train loss."""
    from repro_torch.models import forward
    _r_cfg, cfg, _rp, tp = model
    batch = {k: torch.from_numpy(v) for k, v in
             batch_of(cfg.vocab, 2, 1024, seed=9).items()}
    with torch.no_grad():
        logits, _, _ = forward(cfg, tp, batch["inputs"])
        want = cross_entropy(logits, batch["labels"])
        loss, _ = loss_fn(cfg, tp, batch)
    assert abs(float(loss) - float(want)) <= 1e-6 * float(want)
    assert float(make_eval_step(cfg)(tp, batch)["loss"]) == float(loss)


#: (microbatches, compress_pod_grads, optimizer kwargs).  The clipped
#: AdamW update hardly sees the gradients' scale; unclipped with eps 1e-3
#: it sees the microbatch mean's.
STEP_CASES = [(1, False, {}), (2, False, {}), (1, True, {}),
              (2, False, {"eps": 1e-3, "grad_clip": 1e9})]


@pytest.mark.parametrize("mb,compress,kw", STEP_CASES)
def test_train_step_matches_reference(model, mb, compress, kw):
    r_cfg, cfg, rp, _tp = model
    _, r_o = r_opt.make_optimizer("adamw", lr=3e-3, warmup_steps=1, **kw)
    opt_cfg, o = make_optimizer("adamw", lr=3e-3, warmup_steps=1, **kw)
    r_step = jax.jit(r_trainer.make_train_step(r_cfg, r_o, microbatches=mb,
                                               compress_pod_grads=compress))
    step = make_train_step(cfg, o, microbatches=mb, compress_pod_grads=compress)
    r_state = r_trainer.init_train_state(r_cfg, rp, r_o)
    state = train_state_from_reference(jax.device_get(r_state), cfg, opt_cfg,
                                       device=CPU)
    for i in range(3):
        batch = batch_of(cfg.vocab, 4, 16, seed=40 + i)
        r_state, r_m = r_step(r_state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        want = float(r_m["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want), i
        assert int(m["step"]) == int(r_m["step"]) == i
        assert set(m) == set(r_m)
    assert int(state.step) == 3
    assert_trees(state.params, r_state.params, 1e-4)


def test_train_state_from_reference_round_trips(model):
    r_cfg, cfg, rp, _tp = model
    for name, kw in (("adamw", {}), ("adafactor", {}),
                     ("adamw", {"moment_dtype": "bfloat16",
                                "use_master": True})):
        r_ocfg, r_o = r_opt.make_optimizer(name, **kw)
        ocfg, _o = make_optimizer(name, **kw)
        r_state = r_trainer.init_train_state(r_cfg, rp, r_o)
        g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), rp)
        params, opt_state = r_o.update(rp, g, r_state.opt_state,
                                       jnp.asarray(4, jnp.int32))
        r_state = r_trainer.TrainState(params, opt_state,
                                       jnp.asarray(5, jnp.int32))
        got = train_state_from_reference(jax.device_get(r_state), cfg, ocfg,
                                         device=CPU)
        assert int(got.step) == 5 and got.step.dtype == torch.int32
        assert_trees(got.params, r_state.params, 0, bit_equal=True)
        assert_trees(got.opt_state, r_state.opt_state, 0, bit_equal=True)
    if not torch.cuda.is_available():      # no card: the default raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_state_from_reference(jax.device_get(r_state), cfg, ocfg)
    bad = jax.device_get(r_state)
    bad.opt_state = dict(bad.opt_state)
    del bad.opt_state["m"]
    with pytest.raises(ValueError, match="names differ"):
        train_state_from_reference(bad, cfg, ocfg, device=CPU)
    bad = jax.device_get(r_state)
    bad.opt_state = jax.tree.map(lambda x: x, bad.opt_state)
    bad.opt_state["v"]["final_norm"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        train_state_from_reference(bad, cfg, ocfg, device=CPU)


def test_init_train_state_and_bf16_step_run(model):
    """The port's own init in bf16 (auto master, as ``cfg.optimizer`` is at
    full width): a step keeps every dtype and moves the params."""
    _r_cfg, cfg, _rp, tp = model
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                                act_dtype="bfloat16")
    p16 = tree_map(lambda t: t.to(torch.bfloat16), tp)
    _, o = make_optimizer(cfg16.optimizer, lr=1e-2, warmup_steps=1)
    state = init_train_state(cfg16, p16, o)
    assert set(state.opt_state) == {"m", "v", "master"}
    step = make_train_step(cfg16, o)
    batch = {k: torch.from_numpy(v) for k, v in
             batch_of(cfg.vocab, 2, 16, seed=1).items()}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 for _, p in leaves_with_path(state.params))
