"""Model primitives: norms, RoPE / M-RoPE, GQA attention (full and
sliding-window) and MLA with their decode caches, dense and MoE MLPs, Mamba
(S6) and RWKV6 mixers -- functional PyTorch over nested dicts of tensors.

The port of ``repro.models.layers``.  Names, parameter schemas and the
``[B, S, H, D]`` activation layout are the reference's.  Its ``shard(...)``
annotations are dropped: they do nothing on one card.

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
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import (HEAD_DIMS, flash_attention_bshd,
                                       softmax_scale)

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def apply_norm(p, x, kind: str, eps: float):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
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


def _sdpa(q, k, v, *, causal: bool = True, window: Optional[int] = None,
          q_offset: int = 0, kv_valid: Optional[int] = None,
          softcap: float = 0.0):
    """Grouped-query attention with q-axis chunking: the plain version.

    q [B,S,H,Dk], k [B,T,KV,Dk], v [B,T,KV,Dv] -> [B,S,H,Dv]; fp32 logits
    and softmax, probabilities rounded to v's dtype before P.V (the
    reference's contract).  Masks are formed per chunk.
    """
    b, s, h, dk = q.shape
    t, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    dv = v.shape[-1]
    scale = dk ** -0.5
    qg = q.reshape(b, s, kvh, group, dk)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(t, device=q.device)[None, :]

    def attend(qc, row0: int):
        c = qc.shape[1]
        logits = torch.einsum("bskgd,btkd->bkgst", qc.float(), kf) * scale
        if softcap > 0:
            logits = torch.tanh(logits / softcap) * softcap
        qpos = (row0 + q_offset
                + torch.arange(c, device=q.device)[:, None])
        m = torch.ones((c, t), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        if kv_valid is not None:
            m &= kpos <= kv_valid
        logits = logits.masked_fill(~m, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(), vf)
        return out.reshape(b, c, h, dv)

    if s * t <= _ATTN_CHUNK_THRESHOLD or s <= _ATTN_CHUNK or s % _ATTN_CHUNK:
        out = attend(qg, 0)
    else:
        out = torch.cat([attend(qg[:, i:i + _ATTN_CHUNK], i)
                         for i in range(0, s, _ATTN_CHUNK)], dim=1)
    return out.to(q.dtype)


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
    b, s, d = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    window = spec.window
    kernel = x.is_cuda and not plain_attention

    if mode == "decode":
        newpos = (pos + torch.arange(s, device=x.device))[None, :].expand(b, s)
        q = rotate(cfg, q, newpos)
        k = rotate(cfg, k, newpos)
        k_cache, v_cache = cache["k"], cache["v"]
        cache_len = k_cache.shape[1]
        slot = (pos % cache_len) if window is not None else pos
        k_cache[:, slot:slot + s] = k.to(k_cache.dtype)
        v_cache[:, slot:slot + s] = v.to(v_cache.dtype)
        # Ring buffer: every live slot is within the window by
        # construction; mask only the not-yet-filled slots.  Every row of
        # a longer step is masked at pos, as in the reference.
        valid_upto = min(pos, cache_len - 1) if window is not None else pos
        if kernel:
            o = _flash(q, k_cache, v_cache, causal=False, q_offset=pos,
                       kv_len=valid_upto + 1, softcap=cfg.logit_softcap)
        else:
            o = _sdpa(q, k_cache, v_cache, causal=False, window=None,
                      kv_valid=valid_upto, softcap=cfg.logit_softcap)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = rotate(cfg, q, positions)
        k = rotate(cfg, k, positions)
        if kernel:
            o = _flash(q, k, v, causal=cfg.causal, q_offset=0, window=window,
                       softcap=cfg.logit_softcap)
        else:
            o = _sdpa(q, k, v, causal=cfg.causal, window=window,
                      softcap=cfg.logit_softcap)
        new_cache = None
        if mode == "prefill":
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

    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return y, new_cache


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

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(x.dtype))
    c_kv, k_rope = dkv.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = apply_norm({"scale": p["kv_norm"]}, c_kv, "rmsnorm", cfg.norm_eps)

    if mode == "decode":
        newpos = (pos + torch.arange(s, device=x.device))[None, :].expand(b, s)
        q_rope = rotate(cfg, q_rope, newpos)
        k_rope = rotate(cfg, k_rope[:, :, None, :], newpos)[:, :, 0]
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        ckv_c[:, pos:pos + s] = c_kv.to(ckv_c.dtype)
        kr_c[:, pos:pos + s] = k_rope.to(kr_c.dtype)
        t = ckv_c.shape[1]
        ckv_f = ckv_c.float()
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(),
                             p["w_uk"].float())                   # [B,s,H,R]
        logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv_f)
                  + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                 kr_c.float())) * scale
        valid = torch.arange(t, device=x.device) <= pos
        logits = logits.masked_fill(~valid, -1e30)
        probs = torch.softmax(logits, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", probs, ckv_f)
        o = torch.einsum("bshr,rhv->bshv", o_lat,
                         p["w_uv"].float()).to(x.dtype)
        new_cache = cache
    else:
        pos_ids = (positions if positions is not None
                   else torch.arange(s, device=x.device)[None, :])
        q_rope = rotate(cfg, q_rope, pos_ids)
        k_rope = rotate(cfg, k_rope[:, :, None, :], pos_ids)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(x.dtype))
        v = torch.einsum("bsr,rhv->bshv", c_kv, p["w_uv"].to(x.dtype))
        k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_dim)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        if x.is_cuda and not plain_attention:
            o = _flash(qfull, k, v, causal=cfg.causal, q_offset=0,
                       window=None, softcap=0.0)
        else:
            o = _sdpa(qfull, k, v, causal=cfg.causal)
        new_cache = None
        if mode == "prefill":
            new_cache = {"ckv": c_kv, "krope": k_rope[:, :, 0]}

    y = torch.einsum("bshv,hvd->bsd", o, p["wo"].to(x.dtype))
    return y, new_cache


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
    h = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    if kind == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
        h = F.silu(g.float()).to(x.dtype) * h
    elif kind == "relu2":      # Nemotron-4 squared-ReLU (Primer)
        h = torch.square(F.relu(h.float())).to(x.dtype)
    else:                      # jax.nn.gelu's default: the tanh form
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))


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
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)               # [b, s, k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = int(m.capacity_factor * m.top_k * s / m.n_routed)
    cap = max(cap, min(8, s * m.top_k))
    expert = idx.reshape(b, s * m.top_k)
    onehot = F.one_hot(expert, m.n_routed).float()                # [b, tk, E]
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
    """
    m = cfg.moe
    b, s, d = x.shape
    route = moe_route(cfg, p, x)
    bidx = torch.arange(b, device=x.device)[:, None]
    src = x.repeat_interleave(m.top_k, dim=1)                     # [b, tk, d]
    src = src.masked_fill(~route.keep[..., None], 0)
    buf = x.new_zeros((b, m.n_routed, route.cap, d))
    buf.index_put_((bidx, route.expert, route.slot), src, accumulate=True)

    hg = torch.einsum("becd,edf->becf", buf, p["we_gate"].to(x.dtype))
    hu = torch.einsum("becd,edf->becf", buf, p["we_up"].to(x.dtype))
    h = F.silu(hg.float()).to(x.dtype) * hu
    eo = torch.einsum("becf,efd->becd", h, p["we_down"].to(x.dtype))

    gathered = eo[bidx, route.expert, route.slot]                 # [b, tk, d]
    gathered = gathered.masked_fill(~route.keep[..., None], 0)
    combined = (gathered.reshape(b, s, m.top_k, d).float()
                * route.gates[..., None]).sum(2).to(x.dtype)

    if m.n_shared:
        g = torch.einsum("bsd,df->bsf", x, p["ws_gate"].to(x.dtype))
        u = torch.einsum("bsd,df->bsf", x, p["ws_up"].to(x.dtype))
        sh_h = F.silu(g.float()).to(x.dtype) * u
        combined = combined + torch.einsum("bsf,fd->bsd", sh_h,
                                           p["ws_down"].to(x.dtype))

    # load-balance aux loss (Switch): mean_prob * mean_assignment per expert
    density = route.onehot.reshape(b, s, m.top_k, m.n_routed).sum(2).mean((0, 1))
    mean_prob = route.probs.mean((0, 1))
    aux = (density * mean_prob).sum() * m.n_routed * m.router_aux_weight
    return combined, aux


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


def _mamba_chunk_scan(a, bx, cmat, chunk: int):
    """h_t = a_t * h_{t-1} + bx_t; y_t = C_t . h_t, chunk by chunk, so only
    y [B,T,D] and one chunk's states are ever held.  a/bx: [B,T,D,S] fp32,
    cmat: [B,T,S] fp32, T a multiple of ``chunk``.  Returns (y [B,T,D],
    h_final [B,D,S]).

    Inside a chunk the reference runs ``lax.associative_scan`` with the
    combine ``(a_l a_r, a_r b_l + b_r)``; here the same combine runs as a
    plain scan, left to right in fp32 (torch has no public associative
    scan).  The chunk's start state enters afterwards, as there:
    ``h = prod(a) * h0 + scan(b)``.
    """
    B, T, D, S = a.shape
    h0 = a.new_zeros((B, D, S))
    ys = []
    for c0 in range(0, T, chunk):
        ac, bc = a[:, c0:c0 + chunk], bx[:, c0:c0 + chunk]
        aa, bb = [ac[:, 0]], [bc[:, 0]]
        for t in range(1, ac.shape[1]):
            aa.append(aa[-1] * ac[:, t])
            bb.append(ac[:, t] * bb[-1] + bc[:, t])
        h = torch.stack(aa, 1) * h0[:, None] + torch.stack(bb, 1)
        ys.append(torch.einsum("bqds,bqs->bqd", h, cmat[:, c0:c0 + chunk]))
        h0 = h[:, -1]
    return torch.cat(ys, dim=1), h0


def apply_mamba(cfg, p, x, mode="train", cache=None, pos=None):
    c = cfg.mamba
    b, s, d = x.shape
    d_in = c.expand * d
    dtr = c.dt_rank or -(-d // 16)

    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    u, z = xz.chunk(2, dim=-1)

    if mode == "decode":
        window = torch.cat([cache["conv"], u], dim=1)   # [B, d_conv, d_in]
        new_conv = window[:, 1:]
        uc = (torch.einsum("bkd,kd->bd", window.float(), p["conv_w"].float())
              + p["conv_b"].float())
        uc = F.silu(uc)[:, None]                        # [B,1,d_in]
    else:
        up = torch.cat([u.new_zeros((b, c.d_conv - 1, d_in)), u], dim=1)
        uc = sum(up[:, i:i + s].float() * p["conv_w"].float()[i]
                 for i in range(c.d_conv)) + p["conv_b"].float()
        uc = F.silu(uc)
        new_conv = up[:, -(c.d_conv - 1):]

    xdbc = torch.einsum("bse,ef->bsf", uc.to(x.dtype), p["x_proj"].to(x.dtype))
    dt, bmat, cmat = xdbc.split([dtr, c.d_state, c.d_state], dim=-1)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
    # where log1p(exp(-x)) < 2.1e-9 is below half an fp32 ulp of x.
    dt = F.softplus(torch.einsum("bsr,re->bse", dt.float(), p["dt_w"].float())
                    + p["dt_b"].float())                # [B,S,d_in]
    a = -torch.exp(p["a_log"].float())                  # [d_in, state]
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

    y = y + uc.float() * p["d_skip"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    if mode == "decode":
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(new_ssm)
        return out, cache
    if mode == "prefill":
        return out, {"conv": new_conv.to(x.dtype), "ssm": new_ssm}
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


def _rwkv_chunk(r, k, v, logw, u, chunk: int):
    """Chunked Finch recurrence.  r/k/v/logw: [B,H,T,K] fp32 (V == K), T a
    multiple of ``chunk``.  Every pairwise decay exponent is a difference
    of a cumulative sum inside one chunk with tau < t, hence <= 0, and the
    mask goes in log space before exp: no lane overflows.  Returns
    (out [B,H,T,K], final state [B,H,K,K]).

    The intra-chunk score rounds r, the decay tile and k to bf16 and sums
    their products in fp32, as the reference's einsum with
    ``preferred_element_type=f32`` does: a product of three bf16
    significands (8 bits each) is exact in fp32's 24.
    """
    B, H, T, K = r.shape
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)            # tau < t
    s0 = r.new_zeros((B, H, K, K))
    outs = []
    for c0 in range(0, T, chunk):
        rc, kc, vc, lw = (t[:, :, c0:c0 + chunk] for t in (r, k, v, logw))
        cum = lw.cumsum(2)                               # inclusive
        cum_prev = cum - lw                              # exclusive (t-1)
        # inter-chunk: r_t . D(exp(cum_prev_t)) . S0   (exponents <= 0)
        o_inter = torch.einsum("bhqk,bhkv->bhqv", rc * torch.exp(cum_prev), s0)
        # intra-chunk pairwise decay exp(cum_prev_t - cum_tau), tau < t
        expo = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,H,Q,T,K]
        expo = expo.masked_fill(~tri[:, :, None], float("-inf"))
        pair = _bf16(torch.exp(expo))
        scores = (_bf16(rc)[:, :, :, None, :] * pair
                  * _bf16(kc)[:, :, None, :, :]).sum(-1)  # [B,H,Q,T]
        diag = torch.einsum("bhqk,bhqk->bhq", rc * u[None, :, None, :], kc)
        o_intra = (torch.einsum("bhqt,bhtv->bhqv", scores, vc)
                   + diag[..., None] * vc)
        # state: S' = D(exp(cum_Q)) S0 + sum_tau exp(cum_Q - cum_tau) k v
        total = cum[:, :, -1:]
        k_dec = kc * torch.exp(total - cum)
        s0 = (torch.exp(total.transpose(2, 3)) * s0
              + torch.einsum("bhtk,bhtv->bhkv", k_dec, vc))
        outs.append(o_inter + o_intra)
    return torch.cat(outs, dim=2), s0


def apply_rwkv6(cfg, p, x, mode="train", cache=None, pos=None):
    c = cfg.rwkv
    b, s, d = x.shape
    h, kd = d // c.head_dim, c.head_dim

    prev = cache["shift"] if mode == "decode" else F.pad(x, (0, 0, 1, 0))[:, :s]
    delta = prev - x
    # data-dependent token-shift mixes (5 streams: r,k,v,w,g)
    lora = torch.tanh(torch.einsum("bsd,dm->bsm", x, p["mix_w1"].to(x.dtype)))
    lora = lora.reshape(b, s, 5, c.mix_lora)
    mix = p["mix_mu"].float()[None, None] + torch.einsum(
        "bsfm,fmd->bsfd", lora.float(), p["mix_w2"].float())
    xs = x[:, :, None, :].float() + delta[:, :, None, :].float() * mix
    xr, xk, xv, xw, xg = (xs[:, :, i].to(x.dtype) for i in range(5))

    r = torch.einsum("bsd,dhk->bhsk", xr, p["wr"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bhsk", xk, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bhsk", xv, p["wv"].to(x.dtype))
    g = torch.einsum("bsd,dhk->bhsk", xg, p["wg"].to(x.dtype))

    dec_lora = torch.tanh(torch.einsum("bsd,dl->bsl", xw.float(),
                                       p["decay_w1"].float()))
    decay = p["decay_base"].float()[None, None] + torch.einsum(
        "bsl,lhk->bshk", dec_lora, p["decay_w2"].float())
    logw = -torch.exp(decay).transpose(1, 2)            # [B,H,S,K], < 0

    u = p["u"].float()
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
            new_cache = {"state": final_state, "shift": x[:, -1:]}

    o = out.transpose(1, 2).reshape(b, s, h * kd)
    o = apply_norm({"scale": p["ln_x"], "bias": torch.zeros_like(p["ln_x"])},
                   o.to(x.dtype), "layernorm", 64e-5)
    o = o * F.silu(g.transpose(1, 2).reshape(b, s, h * kd).float()).to(x.dtype)
    o = o.reshape(b, s, h, kd)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return y, new_cache


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
    prev = shift_prev if shift_prev is not None else F.pad(x, (0, 0, 1, 0))[:, :s]
    mu = p["mu_ff"].float()
    delta = (prev - x).float()
    xk = (x.float() + delta * mu[0]).to(x.dtype)
    xr = (x.float() + delta * mu[1]).to(x.dtype)
    k = torch.einsum("bsd,df->bsf", xk, p["wk_ff"].to(x.dtype))
    k = torch.square(F.relu(k.float())).to(x.dtype)
    v = torch.einsum("bsf,fd->bsd", k, p["wv_ff"].to(x.dtype))
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr,
                                   p["wr_ff"].to(x.dtype)).float())
    return (r * v.float()).to(x.dtype)
