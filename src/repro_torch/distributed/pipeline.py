"""Pipeline parallelism (GPipe schedule) as a composable distribution layer.

The port of ``repro.distributed.pipeline``.  For uniform-pattern
architectures (one repeated LayerSpec -- llama, coder, nemotron, hubert,
qwen2-vl) the stacked per-repeat parameters [R, ...] split along the layer
axis over the ``stage`` axis of a device mesh, one stage per rank
(:func:`stage_param_sharding`); activations move stage to stage by
``torch.distributed`` point-to-point sends.

The schedule is the reference's forward pipeline: T = M + S - 1 ticks, each
tick being (run the local layer slice, rotate the boundary activation to the
next stage).  Stage 0 feeds microbatch t; the last stage emits microbatch
t - (S - 1); at the end every rank takes the last stage's outputs.  A stage
with no microbatch at a tick (the bubble) sends zeros rather than compute on
them, as the reference's stage computes and then discards.  The rotation is
a ``torch.autograd.Function`` whose backward is the reverse rotation (the
transpose of ``ppermute``), so ``loss.backward()`` on every rank IS the
reverse pipeline: each rank ends with the gradients of its own layer slice,
and of the embeddings, final norm and head it holds whole, equal to a
sequential run's.

As in the reference, PP is an alternative strategy with its own correctness
proof (a 4-rank CPU test holds it to the sequential forward and gradients),
not wired into the dry-run's sweep.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..models import layers as L
from ..models import transformer as T


def _uniform_spec(cfg):
    if cfg.prefix or len(cfg.pattern) != 1:
        raise ValueError("pipeline stages require a uniform layer pattern")
    return cfg.pattern[0]


def _stage_of(mesh):
    return mesh.get_local_rank("stage"), mesh.size(mesh.mesh_dim_names.index(
        "stage")), mesh.get_group("stage")


def stage_param_sharding(mesh, params: Any, n_stages: int) -> Any:
    """This rank's parameters: its slice [R/S, ...] of every ``blocks``
    leaf (views, along the leading layer axis); the embeddings, final norm
    and head whole (they live on the first and last stage)."""
    stage = mesh.get_local_rank("stage")

    def slice_tree(t):
        if isinstance(t, dict):
            return {k: slice_tree(v) for k, v in t.items()}
        per = t.shape[0] // n_stages
        return t[stage * per:(stage + 1) * per]

    return {k: (slice_tree(v) if k == "blocks" else v)
            for k, v in params.items()}


def _p2p(send: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``send`` to group rank ``to`` while receiving one like it from
    ``frm``."""
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(),
                      dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _Rotate(torch.autograd.Function):
    """Stage i's tensor to stage i + 1 (mod S); the backward sends each
    gradient the other way."""

    @staticmethod
    def forward(ctx, x, stage: int, n: int, group):
        ctx.args = (stage, n, group)
        return _p2p(x, (stage + 1) % n, (stage - 1) % n, group)

    @staticmethod
    def backward(ctx, g):
        stage, n, group = ctx.args
        return _p2p(g, (stage - 1) % n, (stage + 1) % n, group), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank.  Each rank then computes the
    same loss from it, so the backward keeps the last stage's own gradient
    and sends nothing."""

    @staticmethod
    def forward(ctx, x, stage: int, n: int, group):
        ctx.keep = stage == n - 1
        out = x.clone()
        dist.broadcast(out, dist.get_global_rank(group, n - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None, None


class _FromFirst(torch.autograd.Function):
    """Identity on a tensor every rank computes alike (the embedded
    microbatches) of which only stage 0 uses its copy: the backward gives
    every rank stage 0's gradient, so the replicated embedding's gradient
    is whole on every rank."""

    @staticmethod
    def forward(ctx, x, stage: int, group):
        ctx.args = (stage, group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        stage, group = ctx.args
        g = g.contiguous()
        dist.broadcast(g, dist.get_global_rank(group, 0), group=group)
        return g, None, None


def make_pipelined_forward(cfg, mesh, n_stages: int, microbatches: int,
                           plain_attention: bool = False):
    """Returns fn(params, tokens [M*B, S]) -> logits [M*B, S, vocab] on every
    rank, running the decoder blocks as an S-stage GPipe over the mesh's
    ``stage`` axis; ``params`` is this rank's
    (:func:`stage_param_sharding`).  ``plain_attention`` as in
    :func:`repro_torch.models.forward` (training passes True)."""
    spec = _uniform_spec(cfg)
    r = cfg.pattern_repeats()
    if r % n_stages:
        raise ValueError(f"{r} layer repeats do not split into {n_stages} "
                         "stages")
    m = microbatches
    if m < n_stages:
        raise ValueError("GPipe wants M >= S to bound the bubble")

    def blocks_fn(block_params, x):
        """Run this stage's layer slice [R/S, ...] in order."""
        for i in range(r // n_stages):
            x, _, _ = T._apply_block(cfg, spec, T._layer(block_params, i), x,
                                     None, "train", None, None,
                                     plain_attention)
        return x

    def fn(params, tokens):
        stage, n, group = _stage_of(mesh)
        if n != n_stages:
            raise ValueError(f"the mesh's stage axis has {n} ranks, not "
                             f"{n_stages}")
        adt = L.dtype_of(cfg.act_dtype)
        x = params["embed"]["w"].to(adt)[tokens]
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=adt)
        tb, s = tokens.shape
        if tb % m:
            raise ValueError(f"batch {tb} does not split into {m} "
                             "microbatches")
        x_mb = x.reshape(m, tb // m, s, cfg.d_model)
        if n > 1:
            x_mb = _FromFirst.apply(x_mb, stage, group)
        block_params = params["blocks"]["pos0"]
        # Every tick's output depends on the tensor the last tick received
        # (times zero where it is not used), so on every rank the backward
        # reaches the rotations one by one, last tick first, and the ranks'
        # sends and receives pair up.
        buf = x_mb[0] * 0
        outs = [None] * m
        for t in range(m + n - 1):
            mb = t - stage                     # this stage's microbatch
            if 0 <= mb < m:
                y = blocks_fn(block_params,
                              x_mb[t] + buf * 0 if stage == 0 else buf)
                if stage == n - 1:
                    outs[mb] = y
            else:
                y = buf * 0                    # the bubble
            buf = _Rotate.apply(y, stage, n, group) if n > 1 else y
        h = (torch.stack(outs) if stage == n - 1
             else x_mb.new_zeros(x_mb.shape))
        if n > 1:
            h = _FromLast.apply(h + buf * 0, stage, n, group)
        h = h.reshape(tb, s, cfg.d_model)
        h = L.apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        return T._lm_head(cfg, params, h)

    return fn


def pipeline_loss_fn(cfg, mesh, n_stages: int, microbatches: int):
    fwd = make_pipelined_forward(cfg, mesh, n_stages, microbatches,
                                 plain_attention=True)

    def loss(params, batch):
        logits = fwd(params, batch["inputs"])
        return T.cross_entropy(logits, batch["labels"])

    return loss
