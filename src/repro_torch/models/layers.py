"""Model primitives: norms, RoPE / M-RoPE, GQA attention (full and
sliding-window) and MLA with their decode caches, dense and MoE MLPs, Mamba
(S6) and RWKV6 mixers -- functional PyTorch over nested dicts of tensors.

The port of ``repro.models.layers``.  Names, parameter schemas and the
``[B, S, H, D]`` activation layout are the reference's, and so are its
``shard(...)`` annotations, at the same places with the same logical axes
(:mod:`repro_torch.distributed.sharding`).  Inside ``use_rules(rules,
mesh)`` on DTensors they redistribute activations, and :func:`_w` gathers
each parameter's FSDP shards where the layer uses it (XLA's partitioner
inserts that all-gather for the reference; DTensor does not).  Outside such
a context, or on plain tensors, both return their argument unchanged: one
card, and every test, sees the same numbers as without them.  The flash
path hands raw pointers to the kernel and never sees a DTensor: a sharded
run passes ``plain_attention=True``, and :func:`_flash` refuses DTensors.

Numerical contract (the reference's): parameters and activations in
``cfg.act_dtype``, every reduction (softmax, norms, scan states, router) in
fp32.

Decode writes every cache it is given in place (K/V, the MLA latents, the
Mamba conv / ssm states, the RWKV state and token shifts) and returns it;
the reference returns updated copies.  A caller that keeps a cache for
reuse (the KV tier) decodes on a clone of it.

Attention.  On a CUDA device :func:`apply_attn` and :func:`apply_mla` send
every attention call within the flash kernel's contract (no logit softcap,
head dims of at most the largest of
:data:`repro_torch.kernels.flash_attention.HEAD_DIMS`, others zero-padded up
to the next compiled one, MLA's ``Dv < Dk`` by a zero-padded V, no gradient
needed) through the kernel -- prefill with its sliding window, decode with
its key count -- and raise for any other call: there is no silent plain
path on the card.  ``plain_attention=True`` asks for the plain :func:`_sdpa`
on purpose: to hold the kernel path against it, and in training, which is
differentiable only there (the reference trains through ``_sdpa`` too).  On
the CPU attention is :func:`_sdpa`, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (_partial_where, batch_local, batch_mean,
                                    current_rules, elementwise, gather_fsdp,
                                    local_of, shard, split_start, whole,
                                    write_seq)
from ..kernels.flash_attention import (HEAD_DIMS, flash_attention_bshd,
                                       softmax_scale)
from ..tracing import span

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _w(param: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A parameter in ``dtype`` at its use, its FSDP shards gathered under
    a sharding context (:func:`~repro_torch.distributed.sharding.gather_fsdp`)."""
    return gather_fsdp(param.to(dtype))


def dtype_of(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {tuple(DTYPES)}")
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Parameter schema machinery
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | small_normal
    scale: float = 1.0


def init_leaf(gen: torch.Generator, sp: Spec, dtype, device) -> torch.Tensor:
    """One parameter drawn as the reference draws it: zeros, ones, or
    ``normal * scale / sqrt(fan_in)`` in fp32 then cast (the draws are
    ``gen``'s, not JAX's)."""
    if sp.init == "zeros":
        return torch.zeros(sp.shape, dtype=dtype, device=device)
    if sp.init == "ones":
        return torch.ones(sp.shape, dtype=dtype, device=device)
    fan_in = sp.shape[0] if sp.shape else 1
    std = sp.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(sp.shape, generator=gen, dtype=F32, device=device)
    return x.mul_(std).to(dtype)          # in place: one f32 temporary


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_schema(d: int, kind: str) -> Dict[str, Spec]:
    s = {"scale": Spec((d,), (None,), "ones")}
    if kind == "layernorm":
        s["bias"] = Spec((d,), (None,), "zeros")
    return s


def _mean_last(t):
    """``t.mean(-1, keepdim=True)``.  A DTensor (the residual split over
    d_model) takes it as a sum divided by the size: DTensor's mean leaves
    an averaging partial, and the summing partial its gradient arrives as
    cannot be converted back to it."""
    if getattr(t, "placements", None) is None:
        return t.mean(-1, keepdim=True)
    return t.sum(-1, keepdim=True) / t.shape[-1]


def apply_norm(p, x, kind: str, eps: float):
    xf = x.float()
    if kind == "layernorm":
        mu = _mean_last(xf)
        var = _mean_last((xf - mu) ** 2)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * _w(p["scale"], F32) + _w(p["bias"], F32)
    else:
        var = _mean_last(xf ** 2)
        y = xf * torch.rsqrt(var + eps) * _w(p["scale"], F32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=F32, device=device)
                            / dim))


def _rotate_halves(x, cos, sin):
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x [B, S, H, D], positions [B, S] (or [S])."""
    d = x.shape[-1]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions.float()[..., None] * _inv_freq(d, theta, x.device)
    return _rotate_halves(x, torch.cos(ang)[:, :, None, :],
                          torch.sin(ang)[:, :, None, :])


def apply_mrope(x, positions3, theta: float, sections: Tuple[int, int, int]):
    """Qwen2-VL multimodal RoPE: ``positions3`` [3, B, S] carries (temporal,
    height, width) position streams; the rotary feature dim is split into
    three sections, each rotated by its own stream.  For pure text all three
    streams are equal and M-RoPE reduces to RoPE exactly."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {d // 2}")
    freqs = _inv_freq(d, theta, x.device)
    angs, start = [], 0
    for i, sec in enumerate(sections):
        angs.append(positions3[i].float()[..., None] * freqs[start:start + sec])
        start += sec
    ang = torch.cat(angs, dim=-1)[:, :, None, :]          # [B, S, 1, half]
    return _rotate_halves(x, torch.cos(ang), torch.sin(ang))


def rotate(cfg, x, positions):
    """Dispatch on cfg.rope; ``positions`` is [B,S] or [3,B,S] for mrope."""
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        if positions.dim() == 2:                     # text-only: replicate
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding-window) with decode cache
# ---------------------------------------------------------------------------

def attn_schema(cfg) -> Dict[str, Spec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": Spec((d, h, hd), ("fsdp", "heads", None)),
        "wk": Spec((d, kv, hd), ("fsdp", "kv_heads", None)),
        "wv": Spec((d, kv, hd), ("fsdp", "kv_heads", None)),
        "wo": Spec((h, hd, d), ("heads", None, "fsdp")),
    }


#: chunk the q axis whenever the full score matrix would exceed ~this many
#: elements per (batch x head) -- keeps the fp32 logits tile bounded.
_ATTN_CHUNK_THRESHOLD = 4096 * 4096
_ATTN_CHUNK = 512


def _scores(qg, kf, softcap: float):
    """fp32 logits ``[B, KV, G, S, T]`` of grouped queries ``qg``
    [B, S, KV, G, D] against fp32 keys ``kf`` [B, T, KV, D], scaled by
    ``D ** -0.5`` and softcapped."""
    scale = qg.shape[-1] ** -0.5
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), kf) * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def _masked(logits, *, q0: int, k0: int, causal: bool, window: Optional[int],
            kv_valid: Optional[int]):
    """``logits`` [..., rows, keys] with -1e30 where a row may not see a
    key: rows at absolute positions ``q0 + i``, keys at ``k0 + j``; causal,
    within the sliding ``window``, and no key past ``kv_valid``."""
    rows, keys = logits.shape[-2:]
    qpos = q0 + torch.arange(rows, device=logits.device)[:, None]
    kpos = k0 + torch.arange(keys, device=logits.device)[None, :]
    m = torch.ones((rows, keys), dtype=torch.bool, device=logits.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    if kv_valid is not None:
        m &= kpos <= kv_valid
    return logits.masked_fill(~m, -1e30)


def _sdpa(q, k, v, *, causal: bool = True, window: Optional[int] = None,
          q_offset: int = 0, kv_valid: Optional[int] = None,
          softcap: float = 0.0):
    """Grouped-query attention with q-axis chunking: the plain version.

    q [B,S,H,Dk], k [B,T,KV,Dk], v [B,T,KV,Dv] -> [B,S,H,Dv]; fp32 logits
    and softmax, probabilities rounded to v's dtype before P.V (the
    reference's contract).  Masks are formed per chunk.  DTensors (a
    sharded run) go to :func:`_sdpa_sharded`.
    """
    if getattr(q, "placements", None) is not None:
        return _sdpa_sharded(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_valid=kv_valid,
                             softcap=softcap)
    b, s, h, dk = q.shape
    t, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    dv = v.shape[-1]
    qg = q.reshape(b, s, kvh, group, dk)
    kf, vf = k.float(), v.float()

    def attend(qc, row0: int):
        c = qc.shape[1]
        logits = _scores(qc, kf, softcap)
        rules = current_rules()
        if rules is not None and rules.get("attn_q"):
            # Context-parallel scores, only for archs whose head counts
            # cannot shard over the model axis (the rule table opts in).
            # The reference's annotation; on DTensors _sdpa_sharded has
            # split the rows already, and this tile is a local one.
            logits = shard(logits, ("batch", "kv_heads", None, "attn_q", None))
        logits = _masked(logits, q0=row0 + q_offset, k0=0, causal=causal,
                         window=window, kv_valid=kv_valid)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(), vf)
        return out.reshape(b, c, h, dv)

    if s * t <= _ATTN_CHUNK_THRESHOLD or s <= _ATTN_CHUNK or s % _ATTN_CHUNK:
        out = attend(qg, 0)
    else:
        out = torch.cat([attend(qg[:, i:i + _ATTN_CHUNK], i)
                         for i in range(0, s, _ATTN_CHUNK)], dim=1)
    return out.to(q.dtype)


def _sdpa_sharded(q, k, v, *, causal, window, q_offset, kv_valid, softcap):
    """:func:`_sdpa` on DTensors, computed on each rank's local shards, as
    XLA's partitioner splits the reference's attention (DTensor cannot: the
    GQA reshape and the score einsum would merge two split dims).

    Each mesh axis takes one role.  An axis that splits the keys' sequence
    (a decode cache's ``kv_seq``) keeps them split: the query replicates
    over it, each rank scores its keys, and the softmax and P.V combine
    across it as flash-decoding does (all-reduces of the row max, the row
    sum and the partial output, all q-length sized).  An axis that splits
    the batch splits q, K and V alike; one that splits q's heads splits K /
    V's heads too where they divide, else each rank slices the K / V heads
    its q heads read; one that splits q's rows (or that the ``attn_q`` rule
    names: context-parallel scores) offsets the masks.  Any other axis
    replicates all three.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    b, s, h, dk = q.shape
    kvh = k.shape[2]
    rules = current_rules() or {}
    attn_q = rules.get("attn_q")
    attn_q = (attn_q,) if isinstance(attn_q, str) else tuple(attn_q or ())
    roles = []
    for i, (qp, kp) in enumerate(zip(q.placements, k.placements)):
        if kp.is_shard() and kp.dim == 1:
            roles.append("kv_seq")
        elif qp.is_shard() and qp.dim in (0, 1, 2):
            roles.append(("batch", "q_seq", "heads")[qp.dim])
        elif names[i] in attn_q and s % mesh.size(i) == 0:
            roles.append("q_seq")
        else:
            roles.append(None)

    def dims(role):
        return [i for i, r in enumerate(roles) if r == role]

    def size(ds):
        n = 1
        for i in ds:
            n *= mesh.size(i)
        return n

    heads = dims("heads")
    hl, group = h // size(heads), h // kvh
    kv_split = kvh % size(heads) == 0
    if heads and not kv_split and hl % group and group % hl:
        for i in heads:                    # no contiguous K / V block
            roles[i] = None
        heads, hl = [], h
    q_to = tuple(Shard({"batch": 0, "q_seq": 1, "heads": 2}[r])
                 if r in ("batch", "q_seq", "heads") else Replicate()
                 for r in roles)
    kv_to = tuple(Shard(0) if r == "batch" else Shard(1) if r == "kv_seq"
                  else Shard(2) if r == "heads" and kv_split else Replicate()
                  for r in roles)
    # A rank's gradient of a replicated q (keys split) or K / V (rows
    # split, or heads sliced) holds only its part: they sum.
    q_grad = tuple(Partial() if r == "kv_seq" else p
                   for r, p in zip(roles, q_to))
    kv_grad = tuple(Partial() if r == "q_seq" or (r == "heads" and not kv_split)
                    else p for r, p in zip(roles, kv_to))
    ql = local_of(q.redistribute(mesh, q_to), q_grad)
    kl = local_of(k.redistribute(mesh, kv_to), kv_grad)
    vl = local_of(v.redistribute(mesh, kv_to), kv_grad)
    if heads and not kv_split:
        h0 = split_start(mesh, heads, hl)
        lo, hi = h0 // group, (h0 + hl - 1) // group + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    q_off = q_offset + split_start(mesh, dims("q_seq"), ql.shape[1])
    kv_dims = dims("kv_seq")
    if not kv_dims:
        out = _sdpa(ql, kl, vl, causal=causal, window=window, q_offset=q_off,
                    kv_valid=kv_valid, softcap=softcap)
        return DTensor.from_local(out.contiguous(), mesh, q_to,
                                  run_check=False)

    # Keys split over kv_dims: score the local keys, then combine the
    # softmax across those axes.
    sub = mesh[tuple(names[i] for i in kv_dims)]

    def reduce(x, op):
        part = DTensor.from_local(x, sub, (Partial(op),) * len(kv_dims),
                                  run_check=False)
        return part.redistribute(sub, (Replicate(),) * len(kv_dims)).to_local()

    bl, sl, hq, _ = ql.shape
    kl_h = kl.shape[2]
    logits = _scores(ql.reshape(bl, sl, kl_h, hq // kl_h, dk), kl.float(),
                     softcap)
    logits = _masked(logits, q0=q_off,
                     k0=split_start(mesh, kv_dims, kl.shape[1]),
                     causal=causal, window=window, kv_valid=kv_valid)
    # The softmax over every rank's keys, normalised before P is rounded
    # to v's dtype, as _sdpa rounds it.
    top = reduce(logits.detach().amax(-1, keepdim=True), "max")
    p = torch.exp(logits - top)
    probs = p / reduce(p.sum(-1, keepdim=True), "sum")
    o = torch.einsum("bkgst,btkd->bskgd", probs.to(vl.dtype).float(),
                     vl.float())
    o = reduce(o, "sum")
    out = o.reshape(bl, sl, hq, vl.shape[-1]).to(q.dtype).contiguous()
    return DTensor.from_local(out, mesh, q_to, run_check=False)


def _flash(q, k, v, *, causal: bool, q_offset: int, softcap: float,
           window: Optional[int] = None, kv_len: Optional[int] = None):
    """The flash kernel for a call within its contract; raise otherwise.

    The kernels have no backward (nor has the Pallas kernel they replace),
    and their output has no ``grad_fn``: a call that would need one raises
    rather than return a result gradients silently skip.  Training takes
    the plain attention, as the reference's ``loss_fn`` does.  No config
    sets a logit softcap, and the kernels take none.

    ``q``, ``k`` have head dim ``Dk`` and ``v`` ``Dv`` (MLA: 192 and 128).
    All three are zero-padded to the smallest entry of :data:`HEAD_DIMS`
    that holds both (the reduced configs' 8 to 64, MLA's V to 192): zero
    columns of Q and K leave ``Q K^T`` unchanged, zero columns of V give
    zero output columns, which are cut off, and the softmax scale stays
    ``Dk``'s.  In decode that pads a copy of the whole cache every step,
    which is acceptable for the reduced configs only.
    """
    if any(getattr(t, "placements", None) is not None for t in (q, k, v)):
        raise NotImplementedError(
            "the flash kernel takes plain tensors, not DTensors: a sharded "
            "run passes plain_attention=True")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash kernel has no backward: attention that needs a "
            "gradient takes the plain path (plain_attention=True, as the "
            "train step passes), or run under torch.no_grad()")
    if softcap > 0:
        raise NotImplementedError(
            "the flash kernel takes no logit softcap (no config sets one); "
            "use device='cpu' or plain_attention=True for such a model")
    dk, dv = q.shape[-1], v.shape[-1]
    d = max(dk, dv)
    if d > HEAD_DIMS[-1]:
        raise NotImplementedError(
            f"the flash kernel takes head dims of at most {HEAD_DIMS[-1]}, "
            f"not Dk={dk}, Dv={dv}")
    padded = min(x for x in HEAD_DIMS if x >= d)
    masks = dict(causal=causal, q_offset=q_offset, window=window,
                 kv_len=kv_len)
    if padded == dk == dv:
        return flash_attention_bshd(q, k, v, **masks)
    if padded != dk:
        q, k = (F.pad(t, (0, padded - dk)) for t in (q, k))
    if padded != dv:
        v = F.pad(v, (0, padded - dv))
    out = flash_attention_bshd(q, k, v, scale=softmax_scale(dk), **masks)
    return out[..., :dv]


def apply_attn(
    cfg, p, x, positions, spec, mode: str = "train",
    cache: Optional[dict] = None, pos: Optional[int] = None,
    plain_attention: bool = False,
):
    """Returns (y, new_cache).  Modes:
      train   -- full sequence, no cache;
      prefill -- full sequence, build the cache (ring layout for SWA);
      decode  -- x is [B,1,d], read+update cache at ``pos`` (an int), in
                 place.
    """
    with span("layer.attn"):
        return _apply_attn(cfg, p, x, positions, spec, mode, cache, pos,
                           plain_attention)


def _apply_attn(cfg, p, x, positions, spec, mode, cache, pos,
                plain_attention):
    b, s, d = x.shape
    window = spec.window
    kernel = x.is_cuda and not plain_attention
    with span("attn.qkv"):
        q = torch.einsum("bsd,dhk->bshk", x, _w(p["wq"], x.dtype))
        k = torch.einsum("bsd,dhk->bshk", x, _w(p["wk"], x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, _w(p["wv"], x.dtype))
        q = shard(q, ("batch", "seq", "heads", None))
        k = shard(k, ("batch", "seq", "kv_heads", None))
        v = shard(v, ("batch", "seq", "kv_heads", None))
        if mode == "decode":
            positions = (pos + torch.arange(s, device=x.device))[None, :].expand(b, s)
        elif positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = rotate(cfg, q, positions)
        k = rotate(cfg, k, positions)

    if mode == "decode":
        with span("attn.cache_write"):
            k_cache, v_cache = cache["k"], cache["v"]
            cache_len = k_cache.shape[1]
            slot = (pos % cache_len) if window is not None else pos
            write_seq(k_cache, slot, k.to(k_cache.dtype))
            write_seq(v_cache, slot, v.to(v_cache.dtype))
            k_cache = shard(k_cache, ("batch", "kv_seq", "kv_heads", None))
            v_cache = shard(v_cache, ("batch", "kv_seq", "kv_heads", None))
        # Ring buffer: every live slot is within the window by
        # construction; mask only the not-yet-filled slots.  Every row of
        # a longer step is masked at pos, as in the reference.
        valid_upto = min(pos, cache_len - 1) if window is not None else pos
        with span("attn.kernel"):
            if kernel:
                o = _flash(q, k_cache, v_cache, causal=False, q_offset=pos,
                           kv_len=valid_upto + 1, softcap=cfg.logit_softcap)
            else:
                o = _sdpa(q, k_cache, v_cache, causal=False, window=None,
                          kv_valid=valid_upto, softcap=cfg.logit_softcap)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        # K/V (batch x kv_heads)-sharded and seq-replicated at the
        # attention boundary, as the reference pins them.
        k = shard(k, ("batch", None, "kv_heads", None))
        v = shard(v, ("batch", None, "kv_heads", None))
        q = shard(q, ("batch", None, "heads", None))
        with span("attn.kernel"):
            if kernel:
                o = _flash(q, k, v, causal=cfg.causal, q_offset=0,
                           window=window, softcap=cfg.logit_softcap)
            else:
                o = _sdpa(q, k, v, causal=cfg.causal, window=window,
                          softcap=cfg.logit_softcap)
        new_cache = None
        if mode == "prefill":
            with span("attn.cache_write"):
                if window is not None:
                    w = min(window, s)
                    # keep the last `w` positions, laid out in ring order
                    idx = torch.arange(s - w, s, device=x.device) % window
                    kc = k.new_zeros((b, window) + tuple(k.shape[2:]))
                    vc = torch.zeros_like(kc)
                    kc[:, idx] = k[:, s - w:]
                    vc[:, idx] = v[:, s - w:]
                    new_cache = {"k": kc, "v": vc}
                else:
                    new_cache = {"k": k, "v": v}

    with span("attn.out"):
        o = shard(o, ("batch", "seq", "heads", None))
        y = torch.einsum("bshk,hkd->bsd", o, _w(p["wo"], x.dtype))
        return shard(y, ("batch", "seq", "d_model")), new_cache


def attn_cache_schema(cfg, spec, batch: int, max_len: int) -> Dict[str, Spec]:
    hd = cfg.resolved_head_dim
    length = min(spec.window, max_len) if spec.window else max_len
    sh = (batch, length, cfg.n_kv_heads, hd)
    ax = ("batch", "kv_seq", "kv_heads", None)
    return {"k": Spec(sh, ax, "zeros"), "v": Spec(sh, ax, "zeros")}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_schema(cfg) -> Dict[str, Spec]:
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    return {
        "wq": Spec((d, h, m.qk_nope_dim + m.qk_rope_dim), ("fsdp", "heads", None)),
        "w_dkv": Spec((d, m.kv_lora_rank + m.qk_rope_dim), ("fsdp", None)),
        "w_uk": Spec((m.kv_lora_rank, h, m.qk_nope_dim), ("kv_lora", "heads", None)),
        "w_uv": Spec((m.kv_lora_rank, h, m.v_head_dim), ("kv_lora", "heads", None)),
        "wo": Spec((h, m.v_head_dim, d), ("heads", None, "fsdp")),
        "kv_norm": Spec((m.kv_lora_rank,), (None,), "ones"),
    }


def apply_mla(cfg, p, x, positions, spec, mode="train", cache=None, pos=None,
              plain_attention: bool = False):
    """Returns (y, new_cache); modes as :func:`apply_attn`.

    Decode is the reference's absorbed form: it scores in latent space with
    fp32 einsums and never forms per-head K/V (no kernel computes it; it is
    plain PyTorch on every device).  Train and prefill attend with
    Dk = nope + rope (192) against Dv (128): on the card :func:`_flash`
    zero-pads V to Dk, runs the D 192 kernel at the scale Dk**-0.5 (the
    reference's) and cuts the output back to Dv columns; ``plain_attention``
    asks for :func:`_sdpa` instead.
    """
    m = cfg.mla
    b, s, d = x.shape
    h = cfg.n_heads
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5

    q = torch.einsum("bsd,dhk->bshk", x, _w(p["wq"], x.dtype))
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    dkv = torch.einsum("bsd,dr->bsr", x, _w(p["w_dkv"], x.dtype))
    c_kv, k_rope = dkv.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = apply_norm({"scale": p["kv_norm"]}, c_kv, "rmsnorm", cfg.norm_eps)

    if mode == "decode":
        newpos = (pos + torch.arange(s, device=x.device))[None, :].expand(b, s)
        q_rope = rotate(cfg, q_rope, newpos)
        k_rope = rotate(cfg, k_rope[:, :, None, :], newpos)[:, :, 0]
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        write_seq(ckv_c, pos, c_kv.to(ckv_c.dtype))
        write_seq(kr_c, pos, k_rope.to(kr_c.dtype))
        ckv_c = shard(ckv_c, ("batch", "kv_seq", None))
        kr_c = shard(kr_c, ("batch", "kv_seq", None))
        t = ckv_c.shape[1]
        ckv_f = ckv_c.float()
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(),
                             _w(p["w_uk"], F32))                   # [B,s,H,R]
        logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv_f)
                  + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                 kr_c.float())) * scale
        valid = torch.arange(t, device=x.device) <= pos
        logits = logits.masked_fill(~valid, -1e30)
        probs = torch.softmax(logits, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", probs, ckv_f)
        o = torch.einsum("bshr,rhv->bshv", o_lat,
                         _w(p["w_uv"], F32)).to(x.dtype)
        new_cache = cache
    else:
        pos_ids = (positions if positions is not None
                   else torch.arange(s, device=x.device)[None, :])
        q_rope = rotate(cfg, q_rope, pos_ids)
        k_rope = rotate(cfg, k_rope[:, :, None, :], pos_ids)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, _w(p["w_uk"], x.dtype))
        v = torch.einsum("bsr,rhv->bshv", c_kv, _w(p["w_uv"], x.dtype))
        k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_dim)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        qfull = shard(qfull, ("batch", "seq", "heads", None))
        k = shard(k, ("batch", "seq", "heads", None))
        if x.is_cuda and not plain_attention:
            o = _flash(qfull, k, v, causal=cfg.causal, q_offset=0,
                       window=None, softcap=0.0)
        else:
            o = _sdpa(qfull, k, v, causal=cfg.causal)
        new_cache = None
        if mode == "prefill":
            new_cache = {"ckv": c_kv, "krope": k_rope[:, :, 0]}

    o = shard(o, ("batch", "seq", "heads", None))
    y = torch.einsum("bshv,hvd->bsd", o, _w(p["wo"], x.dtype))
    return shard(y, ("batch", "seq", "d_model")), new_cache


def mla_cache_schema(cfg, spec, batch: int, max_len: int) -> Dict[str, Spec]:
    m = cfg.mla
    return {
        "ckv": Spec((batch, max_len, m.kv_lora_rank),
                    ("batch", "kv_seq", None), "zeros"),
        "krope": Spec((batch, max_len, m.qk_rope_dim),
                      ("batch", "kv_seq", None), "zeros"),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_schema(cfg, kind: str) -> Dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    s = {
        "w_up": Spec((d, f), ("fsdp", "d_ff")),
        "w_down": Spec((f, d), ("d_ff", "fsdp")),
    }
    if kind == "swiglu":
        s["w_gate"] = Spec((d, f), ("fsdp", "d_ff"))
    return s


def apply_mlp(cfg, p, x, kind: str):
    h = torch.einsum("bsd,df->bsf", x, _w(p["w_up"], x.dtype))
    h = shard(h, ("batch", "seq", "d_ff"))
    if kind == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, _w(p["w_gate"], x.dtype))
        h = F.silu(g.float()).to(x.dtype) * h
    elif kind == "relu2":      # Nemotron-4 squared-ReLU (Primer)
        h = torch.square(F.relu(h.float())).to(x.dtype)
    else:                      # jax.nn.gelu's default: the tanh form
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = torch.einsum("bsf,fd->bsd", h, _w(p["w_down"], x.dtype))
    return shard(y, ("batch", "seq", "d_model"))


# ---------------------------------------------------------------------------
# Mixture of Experts (shared + routed, capacity-based dispatch)
# ---------------------------------------------------------------------------

def moe_schema(cfg) -> Dict[str, Spec]:
    m, d = cfg.moe, cfg.d_model
    f = m.d_ff_expert or cfg.d_ff
    s = {
        "router": Spec((d, m.n_routed), ("fsdp", None), "normal", 0.2),
        "we_gate": Spec((m.n_routed, d, f), ("experts", "fsdp", "expert_ff")),
        "we_up": Spec((m.n_routed, d, f), ("experts", "fsdp", "expert_ff")),
        "we_down": Spec((m.n_routed, f, d), ("experts", "expert_ff", "fsdp")),
    }
    if m.n_shared:
        s["ws_gate"] = Spec((d, m.n_shared * f), ("fsdp", "d_ff"))
        s["ws_up"] = Spec((d, m.n_shared * f), ("fsdp", "d_ff"))
        s["ws_down"] = Spec((m.n_shared * f, d), ("d_ff", "fsdp"))
    return s


@dataclasses.dataclass
class MoERoute:
    """The router's decision for one MoE call.  A (token, k) pair is one
    token's k-th choice; pairs are token-major along ``S * top_k``."""

    probs: torch.Tensor     # [B, S, E] router softmax, fp32
    gates: torch.Tensor     # [B, S, top_k] top-k probabilities renormalised
    expert: torch.Tensor    # [B, S*top_k] each pair's expert
    slot: torch.Tensor      # [B, S*top_k] its slot in that expert's buffer
    keep: torch.Tensor      # [B, S*top_k] within capacity (else dropped)
    onehot: torch.Tensor    # [B, S*top_k, E] fp32 one-hot of ``expert``
    cap: int                # slots per (sequence, expert)


def moe_route(cfg, p, x) -> MoERoute:
    """Top-k routing with group-local capacity (the reference's): each
    sequence is a routing group, a pair's rank is the number of earlier
    pairs of its group sent to the same expert (a one-hot cumsum), and
    pairs ranked ``cap`` or later are dropped.  A dropped pair keeps the
    slot ``cap - 1`` and carries a zero payload."""
    m = cfg.moe
    b, s, _ = x.shape
    logits = torch.einsum("bsd,de->bse", x.float(), _w(p["router"], F32))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)               # [b, s, k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = int(m.capacity_factor * m.top_k * s / m.n_routed)
    cap = max(cap, min(8, s * m.top_k))
    expert = idx.reshape(b, s * m.top_k)
    onehot = F.one_hot(expert, m.n_routed).float()                # [b, tk, E]
    onehot = shard(onehot, ("batch", None, None))
    rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).long()
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap - 1))
    return MoERoute(probs, gates, expert, slot, keep, onehot, cap)


def apply_moe(cfg, p, x):
    """Group-local capacity dispatch (GShard-style, the reference's):
    payloads are accumulated into a ``[B, E, cap, d]`` buffer, every expert
    runs on its buffer (dense over experts), and each kept pair's output is
    gathered back and combined with its gate in fp32.  Returns (y, the
    Switch load-balance aux loss).

    The scatter accumulates, as the reference's ``.at[].add`` does: a
    dropped pair shares slot ``cap - 1`` with the kept pair there, and its
    zero payload must not overwrite that pair.  Each slot has at most one
    non-zero contributor, so the sum is exact in any order.

    On DTensors the routing, the scatter and the gather run on each rank's
    own sequences (routing groups are sequences, so nothing crosses ranks),
    and the expert products on the DTensor buffer as the rules shard it.
    """
    with span("layer.moe"):
        return _apply_moe(cfg, p, x)


def _apply_moe(cfg, p, x):
    m = cfg.moe
    b, s, d = x.shape
    xl, wrap = batch_local(x)
    bl = xl.shape[0]
    with span("moe.route"):
        route = moe_route(cfg, {"router": whole(_w(p["router"], F32), x)}, xl)
    with span("moe.dispatch"):
        bidx = torch.arange(bl, device=x.device)[:, None]
        src = xl.repeat_interleave(m.top_k, dim=1)                # [b, tk, d]
        src = src.masked_fill(~route.keep[..., None], 0)
        buf = xl.new_zeros((bl, m.n_routed, route.cap, d))
        buf.index_put_((bidx, route.expert, route.slot), src, accumulate=True)
        buf = shard(wrap(buf), ("batch", "experts", None, None))

    with span("moe.experts"):
        hg = torch.einsum("becd,edf->becf", buf, _w(p["we_gate"], x.dtype))
        hu = torch.einsum("becd,edf->becf", buf, _w(p["we_up"], x.dtype))
        hg = shard(hg, ("batch", "experts", None, "expert_ff"))
        h = F.silu(hg.float()).to(x.dtype) * hu
        eo = torch.einsum("becf,efd->becd", h, _w(p["we_down"], x.dtype))
        eo = shard(eo, ("batch", "experts", None, None))

    with span("moe.combine"):
        eo, _ = batch_local(eo)
        gathered = eo[bidx, route.expert, route.slot]             # [b, tk, d]
        gathered = gathered.masked_fill(~route.keep[..., None], 0)
        combined = wrap((gathered.reshape(bl, s, m.top_k, d).float()
                         * route.gates[..., None]).sum(2).to(x.dtype))

    if m.n_shared:
        with span("moe.shared"):
            g = torch.einsum("bsd,df->bsf", x, _w(p["ws_gate"], x.dtype))
            u = torch.einsum("bsd,df->bsf", x, _w(p["ws_up"], x.dtype))
            sh_h = F.silu(g.float()).to(x.dtype) * u
            combined = combined + torch.einsum("bsf,fd->bsd", sh_h,
                                               _w(p["ws_down"], x.dtype))

    # load-balance aux loss (Switch): mean_prob * mean_assignment per expert
    with span("moe.aux"):
        density = batch_mean(route.onehot.reshape(bl, s, m.top_k, m.n_routed)
                             .sum(2).mean((0, 1)), x)
        mean_prob = batch_mean(route.probs.mean((0, 1)), x)
        aux = (density * mean_prob).sum() * m.n_routed * m.router_aux_weight
    return shard(combined, ("batch", "seq", "d_model")), aux


# ---------------------------------------------------------------------------
# Mamba (S6 selective scan, chunked)
# ---------------------------------------------------------------------------

def mamba_schema(cfg) -> Dict[str, Spec]:
    c, d = cfg.mamba, cfg.d_model
    d_in = c.expand * d
    dtr = c.dt_rank or -(-d // 16)
    return {
        "in_proj": Spec((d, 2 * d_in), ("fsdp", "d_ff")),
        "conv_w": Spec((c.d_conv, d_in), (None, "d_ff")),
        "conv_b": Spec((d_in,), ("d_ff",), "zeros"),
        "x_proj": Spec((d_in, dtr + 2 * c.d_state), ("d_ff", None)),
        "dt_w": Spec((dtr, d_in), (None, "d_ff")),
        "dt_b": Spec((d_in,), ("d_ff",), "ones", 0.01),
        "a_log": Spec((d_in, c.d_state), ("d_ff", None), "ones"),
        "d_skip": Spec((d_in,), ("d_ff",), "ones"),
        "out_proj": Spec((d_in, d), ("d_ff", "fsdp")),
    }


def _pad_seq(x, n: int):
    """``x`` [B, S, ...] with ``n`` zero rows in front along S (a token
    shift, a causal conv's history).  A DTensor, whose S no rank splits,
    pads its local shard: torch 2.11's DTensor pad raises on some
    placements."""
    front = (0, 0) * (x.dim() - 2) + (n, 0)
    if getattr(x, "placements", None) is None:
        return F.pad(x, front)
    from torch.distributed.tensor import DTensor

    if any(p.is_shard(1) for p in x.placements):
        raise ValueError(f"the sequence dim is split: {x.placements}")
    return DTensor.from_local(F.pad(local_of(x), front), x.device_mesh,
                              x.placements, run_check=False)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _scan_rounds(a, b):
    """Inclusive scan along dim 1 of h_t = a_t h_{t-1} + b_t from h = 0,
    under the reference's ``associative_scan`` combine ``(a_l a_r,
    a_r b_l + b_r)``: ceil(log2 n) rounds of whole-tensor ops (each element
    combines with the one ``d`` steps back, d = 1, 2, 4, ...; the first
    ``d`` against the identity (1, 0), exactly).  Returns (the products of
    ``a`` so far, the states)."""
    n, d = a.shape[1], 1
    while d < n:
        front = (0, 0) * (a.dim() - 2) + (d, 0)
        b = b + a * F.pad(b[:, :-d], front)
        a = a * F.pad(a[:, :-d], front, value=1.0)
        d *= 2
    return a, b


def _mamba_group(h0, ac, bc, cc):
    """G consecutive chunks ([B,G,Q,D,S]; C [B,G,Q,S]) from the start state
    ``h0`` [B,D,S]: each chunk scanned at once, then its start state carried
    from chunk to chunk, the states formed as the reference forms them,
    ``h = prod(a) * h0 + scan(b)``; (y [B,G,Q,D], the last state)."""
    b, g = ac.shape[:2]
    aa, bb = (t.reshape(ac.shape) for t in _scan_rounds(
        *(t.reshape((b * g,) + t.shape[2:]) for t in (ac, bc))))
    starts = []
    for i in range(g):
        starts.append(h0)
        h0 = aa[:, i, -1] * h0 + bb[:, i, -1]
    h = aa * torch.stack(starts, 1)[:, :, None] + bb
    return torch.einsum("bgqds,bgqs->bgqd", h, cc), h0


#: Elements of the states ([B, chunks, Q, D, S]) one group of Mamba chunks
#: may make at once.
_MAMBA_TILE = 1 << 26


def _mamba_chunk_scan(a, bx, cmat, chunk: int):
    """h_t = a_t * h_{t-1} + bx_t; y_t = C_t . h_t, so that only y [B,T,D]
    and one group's states are ever held.  a/bx: [B,T,D,S] fp32, cmat:
    [B,T,S] fp32, T a multiple of ``chunk``.  Returns (y [B,T,D], h_final
    [B,D,S]).

    Inside a chunk the scan takes log-depth rounds (:func:`_scan_rounds`)
    of the reference's ``lax.associative_scan`` combine.  Chunks go in
    groups whose states hold at most :data:`_MAMBA_TILE` elements (one
    chunk at a time at a card's widths), the start state carried chunk by
    chunk as the reference's ``lax.scan`` carries it; under grad each group
    is recomputed in the backward, as the reference's
    ``jax.checkpoint(body)`` recomputes each chunk.  On DTensors the scan
    runs on each rank's shards (:func:`_mamba_scan_sharded`).
    """
    if getattr(a, "placements", None) is not None:
        return _mamba_scan_sharded(a, bx, cmat, chunk)
    B, T, D, S = a.shape
    nc = T // chunk
    group = max(1, min(nc, _MAMBA_TILE // (B * chunk * D * S)))
    a, bx = (t.reshape(B, nc, chunk, D, S) for t in (a, bx))
    cmat = cmat.reshape(B, nc, chunk, S)
    body = (functools.partial(checkpoint, _mamba_group, use_reentrant=False)
            if _needs_grad(a, bx, cmat) else _mamba_group)
    h = a.new_zeros((B, D, S))
    ys = []
    for g0 in range(0, nc, group):
        y, h = body(h, a[:, g0:g0 + group], bx[:, g0:g0 + group],
                    cmat[:, g0:g0 + group])
        ys.append(y)
    return torch.cat(ys, dim=1).reshape(B, T, D), h


def _mamba_scan_sharded(a, bx, cmat, chunk: int):
    """:func:`_mamba_chunk_scan` on DTensors, on each rank's shards: the
    recurrence is independent along B and D, so a rank scans the rows and
    channels it holds (the sequence and state dims gathered where they
    were split) and DTensor dispatches once a layer, not once a step.
    ``cmat``, read whole by every rank that splits D, sums its gradient
    over those ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = a.device_mesh
    keep = tuple(p if p.is_shard() and p.dim in (0, 2) else Replicate()
                 for p in a.placements)
    c = cmat.redistribute(mesh, tuple(p if p.is_shard(0) else Replicate()
                                      for p in keep))
    y, h = _mamba_chunk_scan(
        local_of(a.redistribute(mesh, keep)),
        local_of(bx.redistribute(mesh, keep)),
        local_of(c, _partial_where(c, keep)), chunk)
    h_at = tuple(Shard(1) if p.is_shard(2) else p for p in keep)
    return (DTensor.from_local(y, mesh, keep, run_check=False),
            DTensor.from_local(h, mesh, h_at, run_check=False))


def apply_mamba(cfg, p, x, mode="train", cache=None, pos=None):
    c = cfg.mamba
    b, s, d = x.shape
    d_in = c.expand * d
    dtr = c.dt_rank or -(-d // 16)

    xz = torch.einsum("bsd,de->bse", x, _w(p["in_proj"], x.dtype))
    xz = shard(xz, ("batch", "seq", "d_ff"))
    u, z = xz.chunk(2, dim=-1)

    if mode == "decode":
        window = torch.cat([cache["conv"], u], dim=1)   # [B, d_conv, d_in]
        new_conv = window[:, 1:]
        uc = (torch.einsum("bkd,kd->bd", window.float(), _w(p["conv_w"], F32))
              + _w(p["conv_b"], F32))
        uc = F.silu(uc)[:, None]                        # [B,1,d_in]
    else:
        up = _pad_seq(u, c.d_conv - 1)
        uc = sum(up[:, i:i + s].float() * _w(p["conv_w"], F32)[i]
                 for i in range(c.d_conv)) + _w(p["conv_b"], F32)
        uc = F.silu(uc)
        new_conv = up[:, -(c.d_conv - 1):]

    xdbc = torch.einsum("bse,ef->bsf", uc.to(x.dtype), _w(p["x_proj"], x.dtype))
    # The product leaves partial sums over the split d_in: reduced here,
    # once, before the three parts go their ways (torch 2.11's DTensor
    # otherwise asks a later product for a placement it cannot reach).
    xdbc = shard(xdbc, ("batch", "seq", None))
    dt, bmat, cmat = xdbc.split([dtr, c.d_state, c.d_state], dim=-1)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
    # where log1p(exp(-x)) < 2.1e-9 is below half an fp32 ulp of x.
    dt = elementwise(F.softplus, torch.einsum(
        "bsr,re->bse", dt.float(), _w(p["dt_w"], F32))
        + _w(p["dt_b"], F32))                           # [B,S,d_in]
    a = -torch.exp(_w(p["a_log"], F32))                  # [d_in, state]
    da = torch.exp(dt[..., None] * a)                   # [B,S,d_in,state]
    bx = (dt * uc)[..., None] * bmat.float()[:, :, None, :]

    if mode == "decode":
        h = cache["ssm"].float() * da[:, 0] + bx[:, 0]
        y = torch.einsum("bds,bs->bd", h, cmat.float()[:, 0])[:, None]
        new_ssm = h
    else:
        chunk = min(c.chunk, s)
        pad = -(-s // chunk) * chunk - s
        cf = cmat.float()
        if pad:
            # pad with identity steps: decay 1, zero input -> state unchanged
            da = F.pad(da, (0, 0, 0, 0, 0, pad), value=1.0)
            bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
            cf = F.pad(cf, (0, 0, 0, pad))
        y, new_ssm = _mamba_chunk_scan(da, bx, cf, chunk)
        y = y[:, :s]

    y = y + uc.float() * _w(p["d_skip"], F32)
    y = (y * F.silu(z.float())).to(x.dtype)
    y = shard(y, ("batch", "seq", "d_ff"))
    out = torch.einsum("bse,ed->bsd", y, _w(p["out_proj"], x.dtype))
    out = shard(out, ("batch", "seq", "d_model"))
    if mode == "decode":
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(new_ssm)
        return out, cache
    if mode == "prefill":
        # copies, not views: a view would hold the whole sequence's tensor
        return out, {"conv": new_conv.to(x.dtype).clone(), "ssm": new_ssm}
    return out, None


def mamba_cache_schema(cfg, spec, batch: int, max_len: int) -> Dict[str, Spec]:
    c = cfg.mamba
    d_in = c.expand * cfg.d_model
    return {
        "conv": Spec((batch, c.d_conv - 1, d_in), ("batch", None, "d_ff"), "zeros"),
        "ssm": Spec((batch, d_in, c.d_state), ("batch", "d_ff", None), "zeros"),
    }


# ---------------------------------------------------------------------------
# RWKV6 (Finch) time mix + channel mix
# ---------------------------------------------------------------------------

def rwkv6_schema(cfg) -> Dict[str, Spec]:
    c, d = cfg.rwkv, cfg.d_model
    h = d // c.head_dim
    k = c.head_dim
    return {
        "wr": Spec((d, h, k), ("fsdp", "heads", None)),
        "wk": Spec((d, h, k), ("fsdp", "heads", None)),
        "wv": Spec((d, h, k), ("fsdp", "heads", None)),
        "wg": Spec((d, h, k), ("fsdp", "heads", None)),
        "wo": Spec((h, k, d), ("heads", None, "fsdp")),
        "u": Spec((h, k), ("heads", None), "normal", 0.5),
        "decay_base": Spec((h, k), ("heads", None), "normal", 0.5),
        "decay_w1": Spec((d, c.decay_lora), ("fsdp", None)),
        "decay_w2": Spec((c.decay_lora, h, k), (None, "heads", None)),
        "mix_mu": Spec((5, d), (None, None), "normal", 0.5),
        "mix_w1": Spec((d, 5 * c.mix_lora), ("fsdp", None)),
        "mix_w2": Spec((5, c.mix_lora, d), (None, None, None)),
        "ln_x": Spec((d,), (None,), "ones"),
    }


def _bf16(t):
    """``t`` rounded to bf16, held in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


#: Elements of the pairwise decay tile ([B, H, chunks, Q, Q, K]) that one
#: group of chunks may make at once.
_RWKV_TILE = 1 << 28


def _rwkv_group(s0, rc, kc, vc, lw, u, tri):
    """G consecutive chunks ([B,H,G,Q,K] each) of :func:`_rwkv_chunk` from
    the state ``s0``: every chunk's own terms at once, then the state
    carried from chunk to chunk; (the outputs, the next state)."""
    cum = lw.cumsum(3)                                   # inclusive
    cum_prev = cum - lw                                  # exclusive (t-1)
    # intra-chunk pairwise decay exp(cum_prev_t - cum_tau), tau < t
    expo = cum_prev[..., :, None, :] - cum[..., None, :, :]  # [B,H,G,Q,T,K]
    expo = expo.masked_fill(~tri[:, :, None], float("-inf"))
    pair = _bf16(torch.exp(expo))
    scores = (_bf16(rc)[..., :, None, :] * pair
              * _bf16(kc)[..., None, :, :]).sum(-1)       # [B,H,G,Q,T]
    diag = torch.einsum("bhgqk,bhgqk->bhgq", rc * u[None, :, None, None, :],
                        kc)
    o_intra = (torch.einsum("bhgqt,bhgtv->bhgqv", scores, vc)
               + diag[..., None] * vc)
    # state: S' = D(exp(cum_Q)) S0 + sum_tau exp(cum_Q - cum_tau) k v
    total = cum[..., -1:, :]
    kv = torch.einsum("bhgtk,bhgtv->bhgkv", kc * torch.exp(total - cum), vc)
    decay = torch.exp(total.transpose(3, 4))              # [B,H,G,K,1]
    # Each chunk's start state: the group's start carried through the
    # chunks before it, in log-depth rounds (S' = decay * S + kv).
    b, h, g, k = kv.shape[:4]
    prod, acc = (t.reshape(b, h, g, k, -1) for t in _scan_rounds(
        decay.reshape(b * h, g, k, 1), kv.reshape(b * h, g, k, k)))
    starts = torch.cat([s0[:, :, None], (prod * s0[:, :, None] + acc)
                        [:, :, :-1]], dim=2)
    # inter-chunk: r_t . D(exp(cum_prev_t)) . S_in   (exponents <= 0)
    o_inter = torch.einsum("bhgqk,bhgkv->bhgqv", rc * torch.exp(cum_prev),
                           starts)
    return o_inter + o_intra, prod[:, :, -1] * s0 + acc[:, :, -1]


def _rwkv_chunk(r, k, v, logw, u, chunk: int):
    """Chunked Finch recurrence.  r/k/v/logw: [B,H,T,K] fp32 (V == K), T a
    multiple of ``chunk``.  Every pairwise decay exponent is a difference
    of a cumulative sum inside one chunk with tau < t, hence <= 0, and the
    mask goes in log space before exp: no lane overflows.  Returns
    (out [B,H,T,K], final state [B,H,K,K]).

    The intra-chunk score rounds r, the decay tile and k to bf16 and sums
    their products in fp32, as the reference's einsum with
    ``preferred_element_type=f32`` does: a product of three bf16
    significands (8 bits each) is exact in fp32's 24.  Chunks go in groups
    whose decay tiles hold at most :data:`_RWKV_TILE` elements: each
    chunk's own terms in one op a group, the state carried across the
    group's chunks in log-depth rounds (:func:`_scan_rounds`; the
    reference's ``lax.scan`` carries it one chunk at a time, so the sums
    associate differently) and from group to group in order.  Under
    grad each group is recomputed in the backward, as the reference's
    ``jax.checkpoint(body)`` recomputes each chunk.  On DTensors the chunks
    run on each rank's shards: the recurrence is independent along B and
    H.
    """
    if getattr(r, "placements", None) is not None:
        return _rwkv_chunk_sharded(r, k, v, logw, u, chunk)
    B, H, T, K = r.shape
    nc = T // chunk
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)            # tau < t
    body = (functools.partial(checkpoint, _rwkv_group, use_reentrant=False)
            if _needs_grad(r, k, v, logw, u) else _rwkv_group)
    group = max(1, min(nc, _RWKV_TILE // (B * H * chunk * chunk * K)))
    r, k, v, logw = (t.reshape(B, H, nc, chunk, K) for t in (r, k, v, logw))
    s0 = r.new_zeros((B, H, K, K))
    outs = []
    for g0 in range(0, nc, group):
        o, s0 = body(s0, *(t[:, :, g0:g0 + group] for t in (r, k, v, logw)),
                     u, tri)
        outs.append(o)
    return torch.cat(outs, dim=2).reshape(B, H, T, K), s0


def _rwkv_chunk_sharded(r, k, v, logw, u, chunk: int):
    """:func:`_rwkv_chunk` on DTensors, on each rank's rows (B) and heads
    (H), the sequence and key dims gathered where they were split; ``u``
    [H, K] split as the heads are, its gradient summed over the ranks that
    split only the rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = r.device_mesh
    keep = tuple(p if p.is_shard() and p.dim in (0, 1) else Replicate()
                 for p in r.placements)
    u_at = u.redistribute(mesh, tuple(Shard(0) if p.is_shard(1)
                                      else Replicate() for p in keep))
    out, state = _rwkv_chunk(
        *(local_of(t.redistribute(mesh, keep)) for t in (r, k, v, logw)),
        local_of(u_at, _partial_where(u_at, keep)), chunk)
    return (DTensor.from_local(out, mesh, keep, run_check=False),
            DTensor.from_local(state, mesh, keep, run_check=False))


def apply_rwkv6(cfg, p, x, mode="train", cache=None, pos=None):
    c = cfg.rwkv
    b, s, d = x.shape
    h, kd = d // c.head_dim, c.head_dim

    prev = cache["shift"] if mode == "decode" else _pad_seq(x, 1)[:, :s]
    delta = prev - x
    # data-dependent token-shift mixes (5 streams: r,k,v,w,g)
    lora = torch.tanh(torch.einsum("bsd,dm->bsm", x, _w(p["mix_w1"], x.dtype)))
    lora = lora.reshape(b, s, 5, c.mix_lora)
    mix = _w(p["mix_mu"], F32)[None, None] + torch.einsum(
        "bsfm,fmd->bsfd", lora.float(), _w(p["mix_w2"], F32))
    xs = x[:, :, None, :].float() + delta[:, :, None, :].float() * mix
    xr, xk, xv, xw, xg = (xs[:, :, i].to(x.dtype) for i in range(5))

    r = torch.einsum("bsd,dhk->bhsk", xr, _w(p["wr"], x.dtype))
    k = torch.einsum("bsd,dhk->bhsk", xk, _w(p["wk"], x.dtype))
    v = torch.einsum("bsd,dhk->bhsk", xv, _w(p["wv"], x.dtype))
    g = torch.einsum("bsd,dhk->bhsk", xg, _w(p["wg"], x.dtype))
    r = shard(r, ("batch", "heads", "seq", None))

    dec_lora = torch.tanh(torch.einsum("bsd,dl->bsl", xw.float(),
                                       _w(p["decay_w1"], F32)))
    decay = _w(p["decay_base"], F32)[None, None] + torch.einsum(
        "bsl,lhk->bshk", dec_lora, _w(p["decay_w2"], F32))
    logw = -torch.exp(decay).transpose(1, 2)            # [B,H,S,K], < 0

    u = _w(p["u"], F32)
    if mode == "decode":
        state = cache["state"].float()                  # [B,H,K,V]
        rf, kf, vf = (t.float()[:, :, 0] for t in (r, k, v))
        kv = kf[:, :, :, None] * vf[:, :, None, :]      # [B,H,K,V]
        o = torch.einsum("bhk,bhkv->bhv", rf, state + u[None, :, :, None] * kv)
        out = o[:, :, None, :]                          # [B,H,1,V]
        new_state = torch.exp(logw[:, :, 0])[:, :, :, None] * state + kv
        cache["state"].copy_(new_state)
        cache["shift"].copy_(x)
        new_cache = cache
    else:
        chunk = min(c.chunk, s)
        pad = -(-s // chunk) * chunk - s
        rf, kf, vf = (t.float() for t in (r, k, v))
        if pad:
            # identity steps: log w = 0 (no decay), k = 0 (no state update)
            rf, kf, vf, logw = (F.pad(t, (0, 0, 0, pad))
                                for t in (rf, kf, vf, logw))
        out, final_state = _rwkv_chunk(rf, kf, vf, logw, u, chunk)
        out = out[:, :, :s]
        new_cache = None
        if mode == "prefill":
            new_cache = {"state": final_state, "shift": x[:, -1:].clone()}

    o = out.transpose(1, 2).reshape(b, s, h * kd)
    o = apply_norm({"scale": p["ln_x"], "bias": torch.zeros_like(p["ln_x"])},
                   o.to(x.dtype), "layernorm", 64e-5)
    o = o * F.silu(g.transpose(1, 2).reshape(b, s, h * kd).float()).to(x.dtype)
    o = o.reshape(b, s, h, kd)
    y = torch.einsum("bshk,hkd->bsd", o, _w(p["wo"], x.dtype))
    return shard(y, ("batch", "seq", "d_model")), new_cache


def rwkv6_cache_schema(cfg, spec, batch: int, max_len: int) -> Dict[str, Spec]:
    c = cfg.rwkv
    h, k = cfg.d_model // c.head_dim, c.head_dim
    return {
        "state": Spec((batch, h, k, k), ("batch", "heads", None, None), "zeros"),
        "shift": Spec((batch, 1, cfg.d_model), ("batch", None, None), "zeros"),
    }


# RWKV channel-mix uses the generic MLP with relu^2 + receptance gate.
def rwkv_ffn_schema(cfg) -> Dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wk_ff": Spec((d, f), ("fsdp", "d_ff")),
        "wv_ff": Spec((f, d), ("d_ff", "fsdp")),
        "wr_ff": Spec((d, d), ("fsdp", None)),
        "mu_ff": Spec((2, d), (None, None), "normal", 0.5),
    }


def apply_rwkv_ffn(cfg, p, x, shift_prev=None):
    b, s, d = x.shape
    prev = shift_prev if shift_prev is not None else _pad_seq(x, 1)[:, :s]
    mu = _w(p["mu_ff"], F32)
    delta = (prev - x).float()
    xk = (x.float() + delta * mu[0]).to(x.dtype)
    xr = (x.float() + delta * mu[1]).to(x.dtype)
    k = torch.einsum("bsd,df->bsf", xk, _w(p["wk_ff"], x.dtype))
    k = shard(k, ("batch", "seq", "d_ff"))
    k = torch.square(F.relu(k.float())).to(x.dtype)
    v = torch.einsum("bsf,fd->bsd", k, _w(p["wv_ff"], x.dtype))
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr,
                                   _w(p["wr_ff"], x.dtype)).float())
    return shard((r * v.float()).to(x.dtype), ("batch", "seq", "d_model"))
