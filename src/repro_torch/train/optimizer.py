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
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]


def _schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step.to(F32) / max(cfg.warmup_steps, 1), 1.0)
    return cfg.lr * warm


def _clip_by_global_norm(grads, max_norm: float):
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                           for g in leaves(grads)))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return tree_map(lambda g: g.to(F32) * scale, grads), gnorm


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

    def update(params, grads, state, step):
        grads, _gnorm = _clip_by_global_norm(grads, cfg.grad_clip)
        lr = _schedule(cfg, step)
        t = step.to(F32) + 1.0
        c1 = 1.0 - cfg.b1 ** t
        c2 = 1.0 - cfg.b2 ** t
        masters = state.get("master", params)

        def upd(master, g, m, v):
            m_new = cfg.b1 * m.to(F32) + (1 - cfg.b1) * g
            v_new = cfg.b2 * v.to(F32) + (1 - cfg.b2) * g * g
            step_ = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
            master_new = (master.to(F32)
                          - lr * (step_ + cfg.weight_decay * master.to(F32)))
            return master_new, m_new.to(mdt), v_new.to(mdt)

        master, m, v = _unzip(
            tree_map(upd, masters, grads, state["m"], state["v"]), 3)
        params_new = tree_map(lambda mast, p: mast.to(p.dtype), master, params)
        new_state = {"m": m, "v": v}
        if "master" in state:
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

    def update(params, grads, state, step):
        grads, _gnorm = _clip_by_global_norm(grads, cfg.grad_clip)
        lr = _schedule(cfg, step)
        t = step.to(F32) + 1.0
        beta2 = 1.0 - t ** (-cfg.decay_rate)
        masters = state.get("master", params)

        def upd(master, g, st):
            master = master.to(F32)
            g2 = g * g + 1e-30
            if "vr" in st:
                vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp_min(vr.mean(-1)[..., None, None], 1e-30))
                prec = torch.rsqrt(denom + cfg.eps)
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
            return master_new, new_st

        is_stat = lambda x: isinstance(x, dict) and ("v" in x or "vr" in x)  # noqa: E731
        # The stats tree has the params' structure down to its stat dicts.
        out = tree_map(lambda st, master, g: upd(master, g, st),
                       state["stats"], masters, grads, is_leaf=is_stat)
        master, stats = _unzip(out, 2)
        params_new = tree_map(lambda m, p: m.to(p.dtype), master, params)
        new_state = {"stats": stats}
        if "master" in state:
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
