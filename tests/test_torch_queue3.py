"""Repairs of ROADMAP Queue 3 (k), (n) and (o) against the reference, on the
CPU.

- (k) ``make_train_step`` for the configs whose modality frontend leaves
  ``embed/w`` unread (hubert-xlarge, qwen2-vl-7b, reduced) under AdamW and
  Adafactor: 3 steps from the reference's state, losses within 1e-5
  relative and every param leaf, ``embed/w`` included, within 1e-4 of its
  largest |value| of the reference's (``tests/test_torch_train.py``'s
  tolerances); ``embed/w`` and its optimizer state after each step
  bit-equal to what the port's optimizer makes of a zero gradient (decay
  only).
- (n) ``remat_policy="dots"`` on reduced nemotron-4-340b at 3 layers: the
  saved set is the outputs of the products with no batch dimension, the
  loss and every gradient bit-equal to full recompute's; the backward
  recomputes only the batched (attention) products; ``remat=False``
  recomputes nothing.
- (o) the log-depth scan of the reference's ``associative_scan`` combine
  within 1e-5 (normwise, ``tests/test_torch_mixers.py``'s block tolerance)
  of a float64 loop and of the reference's scan, its op count a chunk
  growing with log2 of the chunk, not the chunk.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as r_get_config
from repro.models import init_params as r_init_params
from repro.models import layers as RL
from repro.train import optimizer as r_opt
from repro.train import trainer as r_trainer
from repro_torch.configs import get_config
from repro_torch.models import init_params, layers, loss_fn
from repro_torch.models import transformer as T
from repro_torch.train import (make_optimizer, make_train_step,
                               train_state_from_reference)
from repro_torch.tree import leaves, leaves_with_path, unflatten

CPU = "cpu"


def _r_paths(tree):
    return {tuple(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_params(got, want, tol):
    g, w = dict(leaves_with_path(got)), _r_paths(want)
    assert set(g) == set(w)
    for path in sorted(w):
        a, b = g[path].numpy().astype(np.float64), w[path]
        err = float(np.abs(a - b).max())
        assert err <= tol * float(np.abs(b).max()), (path, err)


# ---------------------------------------------------------------------------
# (k) the train step of the frontend configs
# ---------------------------------------------------------------------------

def _frames_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.standard_normal(
                (b, s, cfg.frontend_dim)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-7b"])
def test_frontend_train_step_matches_reference(arch, opt):
    r_cfg, cfg = r_get_config(arch).reduced(), get_config(arch).reduced()
    assert cfg.frontend
    kw = {"lr": 3e-3, "warmup_steps": 1}
    _, r_o = r_opt.make_optimizer(opt, **kw)
    opt_cfg, o = make_optimizer(opt, **kw)
    rp = r_init_params(jax.random.PRNGKey(3), r_cfg)
    r_step = jax.jit(r_trainer.make_train_step(r_cfg, r_o))
    step = make_train_step(cfg, o)
    r_state = r_trainer.init_train_state(r_cfg, rp, r_o)
    state = train_state_from_reference(jax.device_get(r_state), cfg, opt_cfg,
                                       device=CPU)
    for i in range(3):
        batch = _frames_batch(cfg, 2, 16, seed=60 + i)
        # The unread leaf's update by the optimizer's rule for a zero
        # gradient, on the same tensors.
        zero = {"embed": {"w": torch.zeros_like(state.params["embed"]["w"])}}
        sub = {k: ({"embed": v["embed"]} if isinstance(v, dict) else v)
               for k, v in state.opt_state.items()}
        want_embed, want_state = o.update({"embed": state.params["embed"]},
                                          zero, sub, state.step)
        r_state, r_m = r_step(r_state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        want = float(r_m["loss"])
        assert math.isfinite(want)
        assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want), i
        assert torch.equal(state.params["embed"]["w"],
                           want_embed["embed"]["w"]), i
        for path, leaf in leaves_with_path(want_state):
            got = state.opt_state
            for key in path:
                got = got[key]
            assert torch.equal(got, leaf), (i, path)
    assert not torch.equal(state.params["embed"]["w"],
                           torch.from_numpy(np.array(rp["embed"]["w"])))
    _assert_params(state.params, r_state.params, 1e-4)


# ---------------------------------------------------------------------------
# (n) the "dots" remat policy
# ---------------------------------------------------------------------------

class _Products(TorchDispatchMode):
    """Counts matrix products by batch size (1: no batch dimension)."""

    def __init__(self):
        super().__init__()
        self.n = {"single": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            self.n["single" if args[0].shape[0] == 1 else "batched"] += 1
        elif func in T._PRODUCTS:
            self.n["single"] += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, params, batch, remat=True):
    """(loss, gradients, products in the forward, in the backward)."""
    leaf = [p.detach().requires_grad_(True) for p in leaves(params)]
    tree = unflatten(params, leaf)
    with _Products() as fwd:
        hidden, _, _ = T.forward(cfg, tree, batch["inputs"], remat=remat,
                                 return_hidden=True, plain_attention=True)
        logits = T._lm_head(cfg, tree, hidden)
        loss = T.cross_entropy(logits, batch["labels"])
    with _Products() as bwd:
        grads = torch.autograd.grad(loss, leaf)
    return loss.detach(), grads, fwd.n, bwd.n


@pytest.fixture(scope="module")
def nemotron():
    cfg = dataclasses.replace(get_config("nemotron-4-340b").reduced(),
                              n_layers=3)
    assert cfg.remat_policy == "dots"
    params = init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
             for k in ("inputs", "labels")}
    return cfg, params, batch


def test_dots_policy_saves_the_products_and_changes_nothing(nemotron,
                                                            monkeypatch):
    cfg, params, batch = nemotron
    saved = []
    policy = T.dots_policy

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and op in T._PRODUCTS:
            saved.append((str(op), tuple(args[0].shape),
                          out.name == "MUST_SAVE"))
        return out

    monkeypatch.setattr(T, "dots_policy", spy)
    full = dataclasses.replace(cfg, remat_policy="nothing")
    l_full, g_full, fwd, bwd_full = _loss_and_grads(full, params, batch)
    assert not saved
    l_dots, g_dots, fwd_dots, bwd_dots = _loss_and_grads(cfg, params, batch)
    l_none, g_none, _, bwd_none = _loss_and_grads(cfg, params, batch,
                                                  remat=False)
    # The saved set: every product with no batch dimension in the blocks
    # (q, k, v, o, the MLP's two: 6 a layer), nothing else.
    kept = [(op, shp) for op, shp, keep in saved if keep]
    assert len(kept) == 6 * cfg.n_layers
    assert all(op == "aten.bmm.default" and shp[0] == 1 for op, shp in kept)
    assert all(not (op == "aten.bmm.default" and shp[0] == 1)
               for op, shp, keep in saved if not keep)
    # Bit-equal to full recompute, and to no remat at all.
    for got in ((l_dots, g_dots), (l_none, g_none)):
        assert torch.equal(got[0], l_full)
        assert all(torch.equal(a, b) for a, b in zip(got[1], g_full))
    assert fwd_dots == fwd
    # Without remat the backward is two products a forward product; full
    # recompute adds the blocks' products again, "dots" only the batched.
    assert bwd_none == {k: 2 * v for k, v in fwd.items()}
    assert bwd_full["single"] > bwd_none["single"]
    assert bwd_dots["single"] == bwd_none["single"]
    assert bwd_dots["batched"] == bwd_full["batched"] > bwd_none["batched"]


def test_remat_false_in_train_mode_is_the_references_forward(nemotron):
    """``remat=`` is the reference's argument: the logits do not depend
    on it."""
    cfg, params, batch = nemotron
    a, _, _ = T.forward(cfg, params, batch["inputs"], remat=True)
    b, _, _ = T.forward(cfg, params, batch["inputs"], remat=False)
    assert torch.equal(a, b)
    loss, _ = loss_fn(cfg, params, batch)
    assert math.isfinite(float(loss))


# ---------------------------------------------------------------------------
# (o) the log-depth Mamba scan
# ---------------------------------------------------------------------------

def _f64_scan(a, b):
    h = np.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


@pytest.mark.parametrize("n", [1, 5, 8, 13, 64])
def test_scan_rounds_match_float64_and_associative_scan(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    _, got = layers._scan_rounds(torch.from_numpy(a), torch.from_numpy(b))
    want64 = _f64_scan(a.astype(np.float64), b.astype(np.float64))

    def combine(lft, rgt):
        return lft[0] * rgt[0], rgt[0] * lft[1] + rgt[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    for ref in (want64, np.asarray(want)):
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max())


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_mamba_chunk_takes_log_depth_ops():
    """A chunk's ops grow by the same few ops a doubling of its length:
    one round of the scan (the old loop took two ops a step)."""
    rng = np.random.default_rng(0)
    counts = {}
    for chunk in (8, 16, 32, 64, 128, 256):
        a, bx = (torch.from_numpy(rng.uniform(0.5, 1, (1, chunk, 2, 3))
                                  .astype(np.float32)) for _ in range(2))
        c = torch.from_numpy(rng.standard_normal((1, chunk, 3)).astype(
            np.float32))
        with torch.no_grad(), _Ops() as ops:
            layers._mamba_chunk_scan(a, bx, c, chunk)
        counts[chunk] = ops.n
    steps = {counts[2 * c] - counts[c] for c in (8, 16, 32, 64, 128)}
    assert len(steps) == 1 and 0 < steps.pop() <= 12, counts
    assert counts[256] < 256, counts


def test_chunk_scans_under_grad_match_reference_gradients():
    """The per-chunk recompute changes no gradient: the port's scan under
    grad against the reference's ``jax.grad`` of its scan."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 1.0, (2, 24, 3, 4)).astype(np.float32)
    bx = rng.standard_normal((2, 24, 3, 4)).astype(np.float32)
    c = rng.standard_normal((2, 24, 4)).astype(np.float32)

    def r_loss(a, bx, c):
        y, h = RL._mamba_chunk_scan(a, bx, c, 8)
        return jnp.sum(y * y) + jnp.sum(h)

    want = jax.grad(r_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (a, bx, c)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, bx, c)]
    y, h = layers._mamba_chunk_scan(*ts, 8)
    got = torch.autograd.grad((y * y).sum() + h.sum(), ts)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(
            np.abs(w).max())
