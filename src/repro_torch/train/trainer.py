"""Training step construction: grad accumulation, mixed precision, remat,
optional int8 gradient compression.

The port of ``repro.train.trainer``.  ``make_train_step(cfg, optimizer)``
returns ``step(state, batch) -> (state, metrics)``; the reference's
``lax.scan`` over microbatches is a loop here, and nothing is compiled.

Attention in the train step is the plain one (``plain_attention=True``) on
every device: the reference's ``loss_fn`` reaches its plain ``_sdpa``, never
its Pallas kernel, and the port's flash kernel has no backward, as the
Pallas kernel has none.  The eval step needs no gradient, so on the card it
takes the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..distributed.compression import compress_grads_int8, decompress_grads_int8
from ..kernels.ops import resolve_device
from ..models import loss_fn, params_from_reference
from ..tree import leaves, leaves_with_path, tree_map, unflatten
from .optimizer import OPTIMIZERS, DTYPES, Optimizer, OptimizerConfig


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor              # int32, 0-d


def init_train_state(cfg, params, opt: Optimizer) -> TrainState:
    device = leaves(params)[0].device
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(
    cfg,
    optimizer: Optimizer,
    microbatches: int = 1,
    compress_pod_grads: bool = False,
    accum_dtype: str = "float32",
):
    """Returns step(state, batch); batch["inputs"]/["labels"]: [B, S]
    tensors with B the global batch.  With microbatches > 1, B splits into
    [n_mb, B/n_mb] and gradients accumulate in ``accum_dtype``."""
    adt = DTYPES[accum_dtype]

    def grads_of(params, batch):
        leaf = [p.detach().requires_grad_(True) for p in leaves(params)]
        # Plain attention: the reference's train path (module docstring).
        loss, metrics = loss_fn(cfg, unflatten(params, leaf), batch,
                                plain_attention=True)
        grads = torch.autograd.grad(loss, leaf)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten(params, grads))

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if microbatches > 1:
            def split(x):
                b = x.shape[0]
                return x.reshape((microbatches, b // microbatches)
                                 + tuple(x.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves(params)[0].device)
            for i in range(microbatches):
                loss, _metrics, g = grads_of(params,
                                             {k: v[i] for k, v in mb.items()})
                g_sum = tree_map(lambda a, b_: a + b_.to(adt), g_sum, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g.float() / microbatches, g_sum)
            loss = loss_sum / microbatches
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics, grads = grads_of(params, batch)

        if compress_pod_grads:
            # int8 quantize-dequantize models the cross-pod compressed
            # all-reduce (distributed/compression.py).
            grads = decompress_grads_int8(*compress_grads_int8(grads))

        with torch.no_grad():
            new_params, new_opt = optimizer.update(
                params, grads, state.opt_state, state.step)
        new_state = TrainState(new_params, new_opt, state.step + 1)
        metrics = dict(metrics, loss=loss, step=state.step)
        return new_state, metrics

    return step


def make_eval_step(cfg):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(cfg, params, batch)
        return dict(metrics, loss=loss)

    return eval_step


def train_state_from_reference(state, cfg, opt_cfg: OptimizerConfig,
                               device="cuda") -> TrainState:
    """The reference's ``TrainState``, its trees given as numpy (e.g.
    ``jax.tree.map(np.asarray, state)``), as the port's on ``device``.

    The params go through :func:`repro_torch.models.params_from_reference`;
    the optimizer tree is checked leaf by leaf, name and shape, against the
    one ``opt_cfg``'s optimizer builds for those params, and each leaf takes
    that one's dtype (bf16 leaves through float32, which holds them
    exactly).  A missing, extra or misshapen leaf raises, and so does a
    CUDA ``device`` without a Hopper card.
    """
    device = resolve_device(device)
    params = params_from_reference(state.params, cfg, device=device)
    like = OPTIMIZERS[opt_cfg.name](opt_cfg).init(params)
    want = leaves_with_path(like)
    got = dict(leaves_with_path(state.opt_state))
    if {p for p, _ in want} != set(got):
        raise ValueError(f"optimizer state names differ: missing "
                         f"{sorted({p for p, _ in want} - set(got))}, extra "
                         f"{sorted(set(got) - {p for p, _ in want})}")

    def convert(path, w):
        x = got[path]
        if tuple(x.shape) != tuple(w.shape):
            raise ValueError(f"{'/'.join(path)} has shape {tuple(x.shape)}, "
                             f"want {tuple(w.shape)}")
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=device, dtype=w.dtype)

    opt_state = unflatten(like, [convert(p, w) for p, w in want])
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return TrainState(params, opt_state, step)
