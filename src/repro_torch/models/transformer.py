"""The generic heterogeneous transformer stack.

The port of ``repro.models.transformer``: one implementation serves all ten
architectures.  A config's layer *pattern* (attention / SWA / MLA / Mamba /
RWKV6 mixers x dense / MoE / RWKV channel-mix MLPs) is repeated ``R`` times
over stacked per-repeat parameters (leading layer axis), with irregular
leading layers in an unstacked ``prefix``.  The reference's ``lax.scan``
over the stack becomes a Python loop over the layer axis.

The reference's three lowering modes share the code path:
  train   -- full sequence, loss-ready logits; under grad with ``remat``
             each block is recomputed in the backward
             (``torch.utils.checkpoint``, the reference's
             ``jax.checkpoint`` around each block): in full, or under
             ``remat_policy="dots"`` keeping the outputs of the products
             with no batch dimension (:func:`dots_policy`);
  prefill -- full sequence, returns the decode cache;
  decode  -- one token against the cache (KV, MLA latent, Mamba conv + ssm
             state or RWKV state by layer kind), written in place (see
             :mod:`repro_torch.models.layers`).

:func:`loss_fn` is the reference's chunked fused lm-head + cross-entropy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed.sharding import (carried, embed_rows, logsumexp_last, shard,
                                    take_last)
from . import layers as L

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

_MIXER_SCHEMAS = {
    "attn": L.attn_schema,
    "swa": L.attn_schema,
    "mla": L.mla_schema,
    "mamba": L.mamba_schema,
    "rwkv6": L.rwkv6_schema,
}
_MIXER_CACHE_SCHEMAS = {
    "attn": L.attn_cache_schema,
    "swa": L.attn_cache_schema,
    "mla": L.mla_cache_schema,
    "mamba": L.mamba_cache_schema,
    "rwkv6": L.rwkv6_cache_schema,
}


def _layer_schema(cfg, spec) -> Dict[str, Dict[str, L.Spec]]:
    s: Dict[str, Dict[str, L.Spec]] = {
        "norm1": L.norm_schema(cfg.d_model, cfg.norm),
        "mixer": _MIXER_SCHEMAS[spec.mixer](cfg),
        "norm2": L.norm_schema(cfg.d_model, cfg.norm),
    }
    if spec.mlp == "moe":
        s["mlp"] = L.moe_schema(cfg)
    elif spec.mlp == "rwkv_ffn":
        s["mlp"] = L.rwkv_ffn_schema(cfg)
    else:
        s["mlp"] = L.mlp_schema(cfg, spec.mlp)
    return s


def _map_specs(fn, tree, path=()):
    """``fn(path, spec)`` at every leaf of a schema tree (sorted keys)."""
    if isinstance(tree, L.Spec):
        return fn(path, tree)
    return {k: _map_specs(fn, tree[k], path + (k,)) for k in sorted(tree)}


def _stack_schema(schema, r: int):
    return _map_specs(lambda _p, sp: L.Spec((r,) + sp.shape, ("layers",) + sp.axes,
                                            sp.init, sp.scale), schema)


def model_schema(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    r = cfg.pattern_repeats()
    s: Dict[str, Any] = {}
    s["embed"] = {"w": L.Spec((cfg.vocab, d), ("vocab", "fsdp"), "normal", 1.0)}
    if cfg.frontend:
        # Modality-frontend STUB (as in the reference): a projection from
        # precomputed frame/patch embeddings into d_model.
        s["frontend"] = {"proj": L.Spec((cfg.frontend_dim, d), (None, "fsdp"))}
    s["prefix"] = {
        f"layer{i}": _layer_schema(cfg, spec) for i, spec in enumerate(cfg.prefix)
    }
    s["blocks"] = {
        f"pos{i}": _stack_schema(_layer_schema(cfg, spec), r)
        for i, spec in enumerate(cfg.pattern)
    }
    s["final_norm"] = L.norm_schema(d, cfg.norm)
    if not cfg.tie_embeddings:
        s["lm_head"] = {"w": L.Spec((d, cfg.vocab), ("fsdp", "vocab"))}
    return s


def _layer_cache_schema(cfg, spec, batch: int, max_len: int):
    sch = _MIXER_CACHE_SCHEMAS[spec.mixer](cfg, spec, batch, max_len)
    if spec.mixer == "rwkv6":       # the channel mix's token shift
        sch["shift_ffn"] = L.Spec((batch, 1, cfg.d_model),
                                  ("batch", None, None), "zeros")
    return sch


def cache_schema(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    r = cfg.pattern_repeats()
    out: Dict[str, Any] = {"prefix": {}, "blocks": {}}
    for i, spec in enumerate(cfg.prefix):
        out["prefix"][f"layer{i}"] = _layer_cache_schema(cfg, spec, batch,
                                                         max_len)
    for i, spec in enumerate(cfg.pattern):
        out["blocks"][f"pos{i}"] = _stack_schema(
            _layer_cache_schema(cfg, spec, batch, max_len), r)
    return out


def init_params(gen: torch.Generator, cfg, device=None,
                per_layer: bool = False) -> Params:
    """Parameters in ``cfg.param_dtype`` drawn from ``gen`` on ``device``
    (default: the generator's device), leaf by leaf in sorted-path order.

    As in the reference, a leaf's fan-in is its first axis, which for a
    stacked leaf is the layer count: its draws have std ``scale /
    sqrt(repeats)``, independent of the width.  At a depth cut to one or
    two repeats that leaves weights of std ~1, whose bf16 activations
    overflow fp32 in the next norm.  ``per_layer`` draws each stacked leaf
    at its own layer's fan-in (its second axis), as an unstacked layer of
    that shape is drawn."""
    dtype = L.dtype_of(cfg.param_dtype)
    device = gen.device if device is None else torch.device(device)

    def draw(path, sp):
        if per_layer and path[0] == "blocks":
            sp = L.Spec(sp.shape, sp.axes, sp.init,
                        sp.scale * (sp.shape[0] / sp.shape[1]) ** 0.5)
        return L.init_leaf(gen, sp, dtype, device)

    return _map_specs(draw, model_schema(cfg))


def _cache_leaf_dtype(name: str, cfg) -> torch.dtype:
    # Recurrent states (Mamba ssm, RWKV wkv state) accumulate in fp32; KV
    # caches and token-shift states live in the activation dtype.
    return L.F32 if name in ("ssm", "state") else L.dtype_of(cfg.act_dtype)


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Params:
    return _map_specs(
        lambda path, sp: torch.zeros(sp.shape, dtype=_cache_leaf_dtype(
            path[-1], cfg), device=device),
        cache_schema(cfg, batch, max_len))


def param_axes(cfg):
    """The logical axes of every parameter, in :func:`model_schema`'s tree."""
    return _map_specs(lambda _p, sp: sp.axes, model_schema(cfg))


def cache_axes(cfg, batch: int, max_len: int):
    """The logical axes of every cache leaf, in :func:`cache_schema`'s tree."""
    return _map_specs(lambda _p, sp: sp.axes, cache_schema(cfg, batch, max_len))


def params_from_reference(tree, cfg, device="cuda", dtype=None) -> Params:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's, on ``device`` in
    ``dtype`` (default ``cfg.param_dtype``).

    Every leaf's name and shape is checked against :func:`model_schema`;
    a missing, extra or misshapen leaf raises.  bf16 leaves
    (``ml_dtypes.bfloat16``) go through float32, which holds them exactly.
    """
    dtype = L.dtype_of(cfg.param_dtype) if dtype is None else dtype
    schema = model_schema(cfg)

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], path + (k,))
        else:
            yield path, t

    want = dict(leaves(schema))
    got = dict(leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")

    def convert(path, sp):
        x = got[path]
        if tuple(x.shape) != sp.shape:
            raise ValueError(f"{'/'.join(path)} has shape {tuple(x.shape)}, "
                             f"want {sp.shape}")
        arr = np.array(x, dtype=np.float32)      # a writable copy
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return _map_specs(convert, schema)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(cfg, spec, p, x, positions, mode, cache, pos,
                 plain_attention=False):
    """Pre-norm residual block; returns (x, new_cache, aux_loss), the aux
    loss None for a layer without MoE (the reference's zero)."""
    # With the residual split over d_model (the Megatron-SP rule), each
    # sublayer reads it whole: the split is gathered once after the norm,
    # as XLA's partitioner does for the reference, before the products
    # that split their outputs over heads or d_ff.
    h = shard(L.apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps),
              ("batch", "seq", None))
    if spec.mixer in ("attn", "swa"):
        y, new_cache = L.apply_attn(cfg, p["mixer"], h, positions, spec,
                                    mode=mode, cache=cache, pos=pos,
                                    plain_attention=plain_attention)
    elif spec.mixer == "mla":
        y, new_cache = L.apply_mla(cfg, p["mixer"], h, positions, spec,
                                   mode=mode, cache=cache, pos=pos,
                                   plain_attention=plain_attention)
    elif spec.mixer == "mamba":
        y, new_cache = L.apply_mamba(cfg, p["mixer"], h, mode=mode,
                                     cache=cache, pos=pos)
    elif spec.mixer == "rwkv6":
        mixer_cache = cache and {k: v for k, v in cache.items()
                                 if k != "shift_ffn"}
        y, new_cache = L.apply_rwkv6(cfg, p["mixer"], h, mode=mode,
                                     cache=mixer_cache, pos=pos)
    else:
        raise KeyError(spec.mixer)
    x = x + y

    aux = None
    h2 = shard(L.apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps),
               ("batch", "seq", None))
    if spec.mlp == "moe":
        y2, aux = L.apply_moe(cfg, p["mlp"], h2)
    elif spec.mlp == "rwkv_ffn":
        shift_prev = cache["shift_ffn"] if mode == "decode" else None
        y2 = L.apply_rwkv_ffn(cfg, p["mlp"], h2, shift_prev=shift_prev)
        if mode == "decode":
            cache["shift_ffn"].copy_(h2)
        elif mode == "prefill":
            new_cache = dict(new_cache, shift_ffn=h2[:, -1:].clone())
    else:
        y2 = L.apply_mlp(cfg, p["mlp"], h2, spec.mlp)
    return x + y2, new_cache, aux


_MM, _ADDMM, _BMM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                     torch.ops.aten.bmm.default)
#: The matrix products; ``dots_policy`` saves those with no batch dimension:
#: ``mm`` / ``addmm``, and a ``bmm`` whose batch is a single matrix (what an
#: einsum such as ``[B, S, d] x [d, f]`` becomes).  A batched product
#: (attention's scores and P.V) is recomputed.
_PRODUCTS = (_MM, _ADDMM, _BMM)


def _partial_product(a, b) -> bool:
    """True when DTensor operands ``a`` [.., M, K] and ``b`` [.., K, N] split
    the contracted K over one mesh axis: the product is a partial sum."""
    pa, pb = getattr(a, "placements", ()), getattr(b, "placements", ())
    return any(x.is_shard(a.dim() - 1) and y.is_shard(b.dim() - 2)
               for x, y in zip(pa, pb))


def dots_policy(_ctx, op, *args, **_kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable`` as a selective
    checkpoint policy: the outputs of the products with no batch dimension
    are saved, everything else is recomputed.

    On DTensors a row-parallel product (K split: the output projections)
    leaves partial sums of the whole model width, which XLA saves in the
    reduce-scattered form the next annotation gives them; torch saves
    what the op returns, so those are recomputed instead."""
    if op is _ADDMM:
        args = args[1:]                       # (bias, a, b)
    no_batch = op in (_MM, _ADDMM) or (op is _BMM and args[0].shape[0] == 1)
    if no_batch and not _partial_product(args[0], args[1]):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(dots_policy)


def _layer(tree, r: int):
    """Layer ``r`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def forward(
    cfg,
    params: Params,
    inputs: torch.Tensor,          # [B, S] int tokens, or [B, S, F] embeddings
    positions: Optional[torch.Tensor] = None,
    mode: str = "train",
    caches: Optional[Params] = None,
    pos: Optional[int] = None,
    remat: bool = True,
    return_hidden: bool = False,
    plain_attention: bool = False,
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits [B, S, vocab], caches|None, aux_loss); with
    ``return_hidden`` the first element is the final normed hidden state.
    ``aux_loss`` (fp32) sums the MoE layers' load-balance losses, prefix
    first, then the stack in layer order, as the reference's scan does.

    Decode writes into ``caches`` in place and returns the same tree;
    prefill returns new, stacked caches.  ``plain_attention`` takes the
    plain attention on the card too (see :mod:`repro_torch.models.layers`).
    Train mode under grad with ``remat`` saves each block's input and
    recomputes the block in the backward, keeping the products' outputs
    where ``cfg.remat_policy`` is ``"dots"``; without ``remat`` it saves
    what autograd saves.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    adt = L.dtype_of(cfg.act_dtype)
    if inputs.dim() == 3:         # precomputed frontend embeddings [B, S, F]
        x = torch.einsum("bsf,fd->bsd", inputs.to(adt),
                         L._w(params["frontend"]["proj"], adt))
    else:                         # token ids [B, S]
        x = embed_rows(L._w(params["embed"]["w"], adt), inputs)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=adt)
    x = shard(x, ("batch", "seq", "d_model"))

    def block(spec, p, x, cache):
        return _apply_block(cfg, spec, p, x, positions, mode, cache, pos,
                            plain_attention)

    if mode == "prefill":
        plain_prefill = block

        def block(spec, p, x, cache):
            # Each layer's cache is placed by its logical axes as it is
            # made, before the stack: the reference's out_shardings
            # (``cache_axes``), so no rank holds a whole sequence of them.
            x, c, a = plain_prefill(spec, p, x, cache)
            axes = _layer_cache_schema(cfg, spec, x.shape[0], x.shape[1])
            return x, {k: shard(v, axes[k].axes) for k, v in c.items()}, a

    if mode == "train" and remat and torch.is_grad_enabled():
        plain_block = carried(block)          # its recompute may run on
                                              # autograd's device thread
        extra = ({"context_fn": _dots_contexts}
                 if cfg.remat_policy == "dots" else {})

        def block(spec, p, x, cache):
            return checkpoint(plain_block, spec, p, x, cache,
                              use_reentrant=False, **extra)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {"prefix": {}, "blocks": {}}
    for i, spec in enumerate(cfg.prefix):
        name = f"layer{i}"
        c_in = caches["prefix"][name] if caches is not None else None
        x, c_out, a = block(spec, params["prefix"][name], x, c_in)
        if a is not None:
            aux = aux + a
        if c_out is not None:
            new_caches["prefix"][name] = c_out

    r = cfg.pattern_repeats()
    outs = [[] for _ in cfg.pattern]
    for rep in range(r):
        for j, spec in enumerate(cfg.pattern):
            name = f"pos{j}"
            c_in = (_layer(caches["blocks"][name], rep)
                    if caches is not None else None)
            x, c_out, a = block(spec, _layer(params["blocks"][name], rep), x,
                                c_in)
            if a is not None:
                aux = aux + a
            outs[j].append(c_out)
    if mode == "prefill":
        for j, per_rep in enumerate(outs):
            new_caches["blocks"][f"pos{j}"] = {
                k: torch.stack([c[k] for c in per_rep]) for k in per_rep[0]}

    x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if return_hidden:
        return x, None, aux
    logits = shard(_lm_head(cfg, params, x), ("batch", "seq", "vocab"))
    if mode == "decode":
        return logits, caches, aux
    return logits, (new_caches if mode == "prefill" else None), aux


def _lm_head(cfg, params, x):
    adt = L.dtype_of(cfg.act_dtype)
    # Under a sharding context the head reads the whole residual: its
    # d_model split is gathered first, so the vocab-split product needs no
    # partial sums over d (the split XLA derives for the reference from
    # the logits' annotation; DTensor looks no further than this op).
    x = shard(x, ("batch", "seq", None))
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, L._w(params["embed"]["w"], adt))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, L._w(params["lm_head"]["w"], adt))
    if cfg.logit_softcap > 0:
        logits = (torch.tanh(logits.float() / cfg.logit_softcap)
                  * cfg.logit_softcap).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in fp32 (stable logsumexp)."""
    lf = logits.float()
    lse = logsumexp_last(lf)
    gold = take_last(lf, labels)
    return (lse - gold).mean()


#: sequence-chunk size for the fused head+CE loss; [B, chunk, vocab] is the
#: largest loss-side tensor ever materialized.
_LOSS_CHUNK = 512


def loss_fn(cfg, params, batch,
            plain_attention: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked fused lm-head + cross-entropy: the [B, S, vocab] logits are
    never materialized when S is a multiple of :data:`_LOSS_CHUNK` above
    it -- each sequence chunk computes its logits, its logsumexp and its
    gold score, recomputed in the backward so it replays one chunk at a
    time.  Chunks add in sequence order, as the reference's scan does.
    ``plain_attention`` as in :func:`forward`; a train step passes True."""
    hidden, _, aux = forward(cfg, params, batch["inputs"],
                             positions=batch.get("positions"), mode="train",
                             return_hidden=True,
                             plain_attention=plain_attention)
    labels = batch["labels"]
    b, s, _ = hidden.shape

    def chunk_nll(h_c, l_c):
        logits = _lm_head(cfg, params, h_c).float()
        lse = logsumexp_last(logits)
        gold = take_last(logits, l_c)
        return (lse - gold).sum()

    if s % _LOSS_CHUNK == 0 and s > _LOSS_CHUNK:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        recompute = carried(chunk_nll)
        for i in range(0, s, _LOSS_CHUNK):
            h_c, l_c = hidden[:, i:i + _LOSS_CHUNK], labels[:, i:i + _LOSS_CHUNK]
            total = total + (checkpoint(recompute, h_c, l_c, use_reentrant=False)
                             if torch.is_grad_enabled() else chunk_nll(h_c, l_c))
    else:
        total = chunk_nll(hidden, labels)
    ce = total / (b * s)
    return ce + aux, {"ce": ce, "aux": aux}
