"""Model primitives of the dense attention families: norms, RoPE / M-RoPE,
GQA attention (full and sliding-window) with its decode cache, and the dense
MLPs -- functional PyTorch over nested dicts of tensors.

The port of ``repro.models.layers`` for the layers this slice serves.  Names,
parameter schemas and the ``[B, S, H, D]`` activation layout are the
reference's.  Its ``shard(...)`` annotations are dropped: they do nothing on
one card.  MLA, MoE, Mamba and RWKV6 are not ported yet (ROADMAP.md Queue 1
item 13).

Numerical contract (the reference's): parameters and activations in
``cfg.act_dtype``, every reduction (softmax, norms) in fp32.

Attention.  On a CUDA device :func:`apply_attn` sends every attention call
within the flash kernel's contract (no window, no logit softcap, ``Dk == Dv``
of at most the largest of :data:`repro_torch.kernels.flash_attention.HEAD_DIMS`,
smaller ones zero-padded up, decode one token at a time, no gradient needed)
through the kernel, and raises for any other call: there is no silent plain
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

#: Where the flash kernel's missing cases are queued.
KERNEL_TODO = "ROADMAP.md Queue 1 item 14"


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
    return (x * std).to(dtype)


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


def _flash(q, k, v, *, causal: bool, q_offset: int, window, softcap: float):
    """The flash kernel for a call within its contract; raise otherwise.

    The kernels have no backward (nor has the Pallas kernel they replace),
    and their output has no ``grad_fn``: a call that would need one raises
    rather than return a result gradients silently skip.  Training takes
    the plain attention, as the reference's ``loss_fn`` does.

    A head dim below a compiled one (the reduced configs' 8) is zero-padded
    up to the smallest entry of :data:`HEAD_DIMS` that holds it: zero
    columns leave ``Q K^T`` and ``P V`` unchanged, and the softmax scale
    stays the true ``D``'s.  In decode that pads a copy of the whole cache
    every step, which is acceptable for the reduced configs only.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash kernel has no backward: attention that needs a "
            "gradient takes the plain path (plain_attention=True, as the "
            "train step passes), or run under torch.no_grad()")
    if window is not None or softcap > 0:
        raise NotImplementedError(
            "the flash kernel takes no sliding window and no logit softcap "
            f"yet ({KERNEL_TODO}); use device='cpu' for such models")
    d = q.shape[-1]
    if d != v.shape[-1] or d > HEAD_DIMS[-1]:
        raise NotImplementedError(
            f"the flash kernel takes Dk == Dv of at most {HEAD_DIMS[-1]}, not "
            f"Dk={d}, Dv={v.shape[-1]} ({KERNEL_TODO})")
    padded = min(x for x in HEAD_DIMS if x >= d)
    if padded == d:
        return flash_attention_bshd(q, k, v, causal=causal, q_offset=q_offset)
    q, k, v = (F.pad(t, (0, padded - d)) for t in (q, k, v))
    out = flash_attention_bshd(q, k, v, causal=causal, q_offset=q_offset,
                               scale=softmax_scale(d))
    return out[..., :d]


def apply_attn(
    cfg, p, x, positions, spec, mode: str = "train",
    cache: Optional[dict] = None, pos: Optional[int] = None,
    plain_attention: bool = False,
):
    """Returns (y, new_cache).  Modes:
      train   -- full sequence, no cache;
      prefill -- full sequence, build the cache (ring layout for SWA);
      decode  -- x is [B,1,d], read+update cache at ``pos`` (an int).

    Decode writes the new K/V into ``cache`` in place and returns it; the
    reference returns updated copies.  A caller that keeps a cache for
    reuse (the KV tier) decodes on a clone of it.
    """
    b, s, d = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    window = spec.window
    kernel = x.is_cuda and not plain_attention

    if mode == "decode":
        if kernel and s != 1:
            raise NotImplementedError(
                "decode runs one token per step on the card (the reference "
                "masks every row of a longer step at pos)")
        newpos = (pos + torch.arange(s, device=x.device))[None, :].expand(b, s)
        q = rotate(cfg, q, newpos)
        k = rotate(cfg, k, newpos)
        k_cache, v_cache = cache["k"], cache["v"]
        cache_len = k_cache.shape[1]
        slot = (pos % cache_len) if window is not None else pos
        k_cache[:, slot:slot + s] = k.to(k_cache.dtype)
        v_cache[:, slot:slot + s] = v.to(v_cache.dtype)
        if kernel:
            # causal at q_offset=pos == the reference's kv_valid=pos mask
            o = _flash(q, k_cache, v_cache, causal=True, q_offset=pos,
                       window=window, softcap=cfg.logit_softcap)
        else:
            # Ring buffer: every live slot is within the window by
            # construction; mask only the not-yet-filled slots.
            valid_upto = min(pos, cache_len - 1) if window is not None else pos
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
# MLPs
# ---------------------------------------------------------------------------

MLP_KINDS = ("swiglu", "relu2", "gelu")


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
