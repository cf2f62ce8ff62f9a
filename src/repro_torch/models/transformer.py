"""The generic transformer stack, for the dense attention families.

The port of ``repro.models.transformer``: a config's layer *pattern* is
repeated ``R`` times over stacked per-repeat parameters (leading layer axis),
with irregular leading layers in an unstacked ``prefix``.  The reference's
``lax.scan`` over the stack becomes a Python loop over the layer axis.

The reference's three lowering modes share the code path:
  train   -- full sequence, loss-ready logits; under grad each block is
             recomputed in the backward (``torch.utils.checkpoint``, the
             reference's ``jax.checkpoint`` around each block; its
             ``remat_policy="dots"``, which saves the products, is
             recomputed in full here);
  prefill -- full sequence, returns the decode cache;
  decode  -- one token against the cache, written in place at ``pos``
             (see :func:`repro_torch.models.layers.apply_attn`).

:func:`loss_fn` is the reference's chunked fused lm-head + cross-entropy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L

Params = Dict[str, Any]

NOT_PORTED = ("MLA, MoE, Mamba and RWKV6 layers are not ported yet "
              "(ROADMAP.md Queue 1 item 13)")


def _require_ported(spec) -> None:
    if spec.mixer not in ("attn", "swa") or spec.mlp not in L.MLP_KINDS:
        raise NotImplementedError(f"{spec.mixer} / {spec.mlp}: {NOT_PORTED}")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def _layer_schema(cfg, spec) -> Dict[str, Dict[str, L.Spec]]:
    _require_ported(spec)
    return {
        "norm1": L.norm_schema(cfg.d_model, cfg.norm),
        "mixer": L.attn_schema(cfg),
        "norm2": L.norm_schema(cfg.d_model, cfg.norm),
        "mlp": L.mlp_schema(cfg, spec.mlp),
    }


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


def cache_schema(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    r = cfg.pattern_repeats()
    out: Dict[str, Any] = {"prefix": {}, "blocks": {}}
    for i, spec in enumerate(cfg.prefix):
        _require_ported(spec)
        out["prefix"][f"layer{i}"] = L.attn_cache_schema(cfg, spec, batch, max_len)
    for i, spec in enumerate(cfg.pattern):
        _require_ported(spec)
        out["blocks"][f"pos{i}"] = _stack_schema(
            L.attn_cache_schema(cfg, spec, batch, max_len), r)
    return out


def init_params(gen: torch.Generator, cfg, device=None) -> Params:
    """Parameters in ``cfg.param_dtype`` drawn from ``gen`` on ``device``
    (default: the generator's device), leaf by leaf in sorted-path order."""
    dtype = L.dtype_of(cfg.param_dtype)
    device = gen.device if device is None else torch.device(device)
    return _map_specs(lambda _p, sp: L.init_leaf(gen, sp, dtype, device),
                      model_schema(cfg))


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Params:
    dtype = L.dtype_of(cfg.act_dtype)
    return _map_specs(
        lambda _p, sp: torch.zeros(sp.shape, dtype=dtype, device=device),
        cache_schema(cfg, batch, max_len))


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
    """Pre-norm residual block; returns (x, new_cache)."""
    _require_ported(spec)
    h = L.apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    y, new_cache = L.apply_attn(cfg, p["mixer"], h, positions, spec, mode=mode,
                                cache=cache, pos=pos,
                                plain_attention=plain_attention)
    x = x + y
    h2 = L.apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + L.apply_mlp(cfg, p["mlp"], h2, spec.mlp), new_cache


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
    return_hidden: bool = False,
    plain_attention: bool = False,
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits [B, S, vocab], caches|None, aux_loss); with
    ``return_hidden`` the first element is the final normed hidden state.
    ``aux_loss`` is 0: the dense layers have none (MoE's waits with MoE).

    Decode writes into ``caches`` in place and returns the same tree;
    prefill returns new, stacked caches.  ``plain_attention`` takes the
    plain attention on the card too (see :mod:`repro_torch.models.layers`).
    Train mode under grad saves only each block's input and recomputes the
    block in the backward.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    adt = L.dtype_of(cfg.act_dtype)
    if inputs.dim() == 3:         # precomputed frontend embeddings [B, S, F]
        x = torch.einsum("bsf,fd->bsd", inputs.to(adt),
                         params["frontend"]["proj"].to(adt))
    else:                         # token ids [B, S]
        x = params["embed"]["w"].to(adt)[inputs]
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=adt)

    def block(spec, p, x, cache):
        return _apply_block(cfg, spec, p, x, positions, mode, cache, pos,
                            plain_attention)

    if mode == "train" and torch.is_grad_enabled():
        plain_block = block

        def block(spec, p, x, cache):
            return checkpoint(plain_block, spec, p, x, cache,
                              use_reentrant=False)

    new_caches: Dict[str, Any] = {"prefix": {}, "blocks": {}}
    for i, spec in enumerate(cfg.prefix):
        name = f"layer{i}"
        c_in = caches["prefix"][name] if caches is not None else None
        x, c_out = block(spec, params["prefix"][name], x, c_in)
        if c_out is not None:
            new_caches["prefix"][name] = c_out

    r = cfg.pattern_repeats()
    outs = [[] for _ in cfg.pattern]
    for rep in range(r):
        for j, spec in enumerate(cfg.pattern):
            name = f"pos{j}"
            c_in = (_layer(caches["blocks"][name], rep)
                    if caches is not None else None)
            x, c_out = block(spec, _layer(params["blocks"][name], rep), x, c_in)
            outs[j].append(c_out)
    if mode == "prefill":
        for j, per_rep in enumerate(outs):
            new_caches["blocks"][f"pos{j}"] = {
                k: torch.stack([c[k] for c in per_rep]) for k in per_rep[0]}

    x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, None, aux
    logits = _lm_head(cfg, params, x)
    if mode == "decode":
        return logits, caches, aux
    return logits, (new_caches if mode == "prefill" else None), aux


def _lm_head(cfg, params, x):
    adt = L.dtype_of(cfg.act_dtype)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]["w"].to(adt))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"]["w"].to(adt))
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
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None].long())[..., 0]
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
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, l_c[..., None].long())[..., 0]
        return (lse - gold).sum()

    if s % _LOSS_CHUNK == 0 and s > _LOSS_CHUNK:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, s, _LOSS_CHUNK):
            h_c, l_c = hidden[:, i:i + _LOSS_CHUNK], labels[:, i:i + _LOSS_CHUNK]
            total = total + (checkpoint(chunk_nll, h_c, l_c, use_reentrant=False)
                             if torch.is_grad_enabled() else chunk_nll(h_c, l_c))
    else:
        total = chunk_nll(hidden, labels)
    ce = total / (b * s)
    return ce + aux, {"ce": ce, "aux": aux}
