"""Optimizers over parameter trees: AdamW and Adafactor.

The port of ``repro.train.optimizer``: plain functions on nested dicts of
tensors, no ``torch.optim``.  Moment dtypes are configurable (bf16 halves
optimizer memory); Adafactor factors the second moment of any weight whose
two trailing dims are both at least ``min_dim_factored`` into row and
column statistics.

The state layout mirrors the param tree leaf for leaf, as the reference's
does: AdamW ``{"m", "v"[, "master"]}``, Adafactor ``{"stats"[, "master"]}``
with ``{"vr", "vc"}`` or ``{"v"}`` a leaf.  The arithmetic is the
reference's in float32: the step count, the schedule and the bias
corrections are float32 tensors (the reference's ``b1 ** t`` is a float32
power, and its schedule gives lr 0 at step 0), and the global norm adds the
leaves' squares in sorted-path order (``jax.tree.leaves``'s).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..distributed.sharding import from_local_like, local_like, placed_like
from ..tree import leaves, tree_map

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # bf16 halves optimizer memory
    use_master: Optional[bool] = None  # None: auto (master iff params < fp32);
    # False: pure low-precision training, update in param dtype
    warmup_steps: int = 100
    # adafactor
    decay_rate: float = 0.8
    min_dim_factored: int = 128


class Optimizer(NamedTuple):
    """``update(params, grads, state, step, grad_div=1.0)`` takes each
    gradient leaf in any dtype and placement, in float32 over ``grad_div``,
    and updates the tree leaf by leaf: a leaf's float32 temporaries are
    freed before the next leaf is read."""

    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def _schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step.to(F32) / max(cfg.warmup_steps, 1), 1.0)
    return cfg.lr * warm


def _f32(g: torch.Tensor, div: float) -> torch.Tensor:
    """A gradient leaf in float32, divided by ``div`` (the trainer's
    microbatch count) as the reference's trainer divides its whole tree."""
    return g.to(F32) if div == 1 else g.to(F32) / div


def _clip_scale(grads, max_norm: float, div: float = 1.0) -> torch.Tensor:
    """The factor that clips the float32 gradients (each leaf over ``div``)
    to the global norm ``max_norm``: the reference's
    ``_clip_by_global_norm``, its squares added in the same order, one
    leaf's float32 copy alive at a time.  Each update multiplies a leaf by
    it where it reads the leaf."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(_f32(g, div)))
                           for g in leaves(grads)))
    return torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)


def _needs_master(cfg: OptimizerConfig, params) -> bool:
    """A separate fp32 master copy is only needed when the working params are
    low precision and the config hasn't opted into pure low-precision
    training."""
    if cfg.use_master is not None:
        return cfg.use_master
    return any(p.dtype != F32 for p in leaves(params))


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _unzip(out, n: int):
    """A tree of n-tuples -> n trees."""
    is_tuple = lambda x: isinstance(x, tuple)  # noqa: E731
    return tuple(tree_map(lambda o, i=i: o[i], out, is_leaf=is_tuple)
                 for i in range(n))


def make_adamw(cfg: OptimizerConfig) -> Optimizer:
    mdt = DTYPES[cfg.moment_dtype]

    def init(params):
        state = {
            "m": tree_map(lambda p: _zeros(p.shape, mdt, p), params),
            "v": tree_map(lambda p: _zeros(p.shape, mdt, p), params),
        }
        if _needs_master(cfg, params):
            state["master"] = tree_map(lambda p: p.to(F32), params)
        return state

    def update(params, grads, state, step, grad_div=1.0):
        scale = _clip_scale(grads, cfg.grad_clip, grad_div)
        lr = _schedule(cfg, step)
        t = step.to(F32) + 1.0
        c1 = 1.0 - cfg.b1 ** t
        c2 = 1.0 - cfg.b2 ** t
        masters = state.get("master", params)
        keep = "master" in state

        def upd(p, master, g, m, v):
            g = _f32(placed_like(g, p), grad_div) * scale
            m_new = cfg.b1 * m.to(F32) + (1 - cfg.b1) * g
            v_new = cfg.b2 * v.to(F32) + (1 - cfg.b2) * g * g
            step_ = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
            master_new = (master.to(F32)
                          - lr * (step_ + cfg.weight_decay * master.to(F32)))
            return (master_new.to(p.dtype), master_new if keep else None,
                    m_new.to(mdt), v_new.to(mdt))

        params_new, master, m, v = _unzip(tree_map(
            upd, params, masters, grads, state["m"], state["v"]), 4)
        new_state = {"m": m, "v": v}
        if keep:
            new_state["master"] = master
        return params_new, new_state

    return Optimizer(init, update)


def make_adafactor(cfg: OptimizerConfig) -> Optimizer:
    """Factored second moment (Shazeer & Stern, arXiv:1804.04235), no first
    moment: optimizer state ~= params fp32 master + O(rows+cols) stats."""

    def _factored(shape) -> bool:
        return (len(shape) >= 2
                and shape[-1] >= cfg.min_dim_factored
                and shape[-2] >= cfg.min_dim_factored)

    def init(params):
        def mk(p):
            if _factored(p.shape):
                return {"vr": _zeros(p.shape[:-1], F32, p),
                        "vc": _zeros(p.shape[:-2] + p.shape[-1:], F32, p)}
            return {"v": _zeros(p.shape, F32, p)}

        state = {"stats": tree_map(mk, params)}
        if _needs_master(cfg, params):
            state["master"] = tree_map(lambda p: p.to(F32), params)
        return state

    def update(params, grads, state, step, grad_div=1.0):
        scale = _clip_scale(grads, cfg.grad_clip, grad_div)
        lr = _schedule(cfg, step)
        t = step.to(F32) + 1.0
        beta2 = 1.0 - t ** (-cfg.decay_rate)
        masters = state.get("master", params)
        keep = "master" in state

        def upd(p, master, g, st):
            master = master.to(F32)
            g = _f32(placed_like(g, p), grad_div) * scale
            g2 = g * g + 1e-30
            if "vr" in st:
                vr = placed_like(beta2 * st["vr"] + (1 - beta2) * g2.mean(-1),
                                 st["vr"])
                vc = placed_like(beta2 * st["vc"] + (1 - beta2) * g2.mean(-2),
                                 st["vc"])
                # The outer product is formed on g's own shards: DTensor
                # would broadcast it in a placement of its choosing.
                rows, cols, mean = local_like(
                    g, (vr, range(g.dim() - 1)),
                    (vc, [*range(g.dim() - 2), g.dim() - 1]),
                    (vr.mean(-1), range(g.dim() - 2)))
                prec = from_local_like(torch.rsqrt(
                    rows[..., None] * cols[..., None, :]
                    / torch.clamp_min(mean[..., None, None], 1e-30)
                    + cfg.eps), g)
                new_st = {"vr": vr, "vc": vc}
            else:
                v = beta2 * st["v"] + (1 - beta2) * g2
                prec = torch.rsqrt(v + cfg.eps)
                new_st = {"v": v}
            upd_ = g * prec
            # update clipping (RMS <= 1), as in the paper
            rms = torch.sqrt(torch.mean(torch.square(upd_)) + 1e-30)
            upd_ = upd_ / torch.clamp_min(rms, 1.0)
            master_new = master - lr * (upd_ + cfg.weight_decay * master)
            return (master_new.to(p.dtype), master_new if keep else None,
                    new_st)

        is_stat = lambda x: isinstance(x, dict) and ("v" in x or "vr" in x)  # noqa: E731
        # The stats tree has the params' structure down to its stat dicts.
        out = tree_map(lambda st, p, master, g: upd(p, master, g, st),
                       state["stats"], params, masters, grads, is_leaf=is_stat)
        params_new, master, stats = _unzip(out, 3)
        new_state = {"stats": stats}
        if keep:
            new_state["master"] = master
        return params_new, new_state

    return Optimizer(init, update)


#: Each optimizer's constructor, by ``OptimizerConfig.name``.
OPTIMIZERS = {"adamw": make_adamw, "adafactor": make_adafactor}


def make_optimizer(name: str, **kw) -> Tuple[OptimizerConfig, Optimizer]:
    cfg = OptimizerConfig(name=name, **kw)
    return cfg, OPTIMIZERS[name](cfg)


def opt_state_axes(cfg: OptimizerConfig, params_struct, axes_tree):
    """Logical-axes tree mirroring the optimizer state layout, so optimizer
    state shards exactly like parameters.  Adafactor's factored statistics
    drop the reduced dimension's axis.  ``params_struct``'s leaves need only
    ``shape`` and ``dtype`` (meta tensors will do)."""
    has_master = _needs_master(cfg, params_struct)
    if cfg.name == "adamw":
        out = {"m": axes_tree, "v": axes_tree}
        if has_master:
            out["master"] = axes_tree
        return out

    def _factored(shape) -> bool:
        return (len(shape) >= 2
                and shape[-1] >= cfg.min_dim_factored
                and shape[-2] >= cfg.min_dim_factored)

    def stat_axes(axes, st):
        if _factored(st.shape):
            return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
        return {"v": axes}

    out = {"stats": tree_map(stat_axes, axes_tree, params_struct)}
    if has_master:
        out["master"] = axes_tree
    return out
