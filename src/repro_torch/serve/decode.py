"""Serving steps: prefill + single-token decode over heterogeneous caches.

The port of ``repro.serve.decode``: one new token against a
``max_len``-deep cache (KV ring buffers for SWA, MLA latent caches, Mamba
conv + ssm states, RWKV wkv states -- whatever the layer pattern dictates).
Positions are Python ints.  :func:`serve_step` writes the new token's
caches into the caches it is given and returns them; the reference returns
updated copies.  A caller that keeps a cache for later reuse decodes on a
clone.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import forward, init_cache

#: Rank of each cache leaf that carries a sequence axis (axis 1), unstacked.
_BASE_NDIM = {"k": 4, "v": 4, "ckv": 3, "krope": 3}


def grow_cache(cfg, caches: Dict[str, Any], max_len: int) -> Dict[str, Any]:
    """Pad prefill-built caches along the sequence axis to ``max_len`` so
    decode can keep appending.  Ring-buffer (SWA) and state caches pass
    through unchanged.  The grown caches are new tensors."""
    out: Dict[str, Any] = {}
    for group, layers in caches.items():
        out[group] = {}
        for name, cache in layers.items():
            idx = int(name.replace("layer", "").replace("pos", ""))
            spec = cfg.prefix[idx] if group == "prefix" else cfg.pattern[idx]
            out[group][name] = {key: _grow(x, key, spec, max_len)
                                for key, x in cache.items()}
    return out


def _grow(x: torch.Tensor, key: str, spec, max_len: int) -> torch.Tensor:
    if key not in _BASE_NDIM or spec.window:
        return x                 # ring buffer: fixed at window length
    # caches are [B, S, ...]; stacked block caches add a leading layer
    # axis ([R, B, S, ...]), shifting the sequence axis by one.
    ax = 1 + (x.dim() - _BASE_NDIM[key])
    cur = x.shape[ax]
    if cur >= max_len:
        return x
    shape = list(x.shape)
    shape[ax] = max_len
    grown = x.new_zeros(shape)
    grown.narrow(ax, 0, cur).copy_(x)
    return grown


def prefill(cfg, params, inputs, max_len: Optional[int] = None,
            positions=None) -> Tuple[torch.Tensor, Dict[str, Any], int]:
    """Run the prompt, return (last-token logits, caches grown to max_len,
    next position)."""
    s = inputs.shape[1]
    logits, caches, _ = forward(cfg, params, inputs, positions=positions,
                                mode="prefill")
    if max_len is not None:
        caches = grow_cache(cfg, caches, max_len)
    return logits[:, -1], caches, s


def serve_step(cfg, params, caches, tokens, pos: int):
    """One decode step: tokens [B, 1] (or [B, 1, F] embeddings), ``pos`` the
    cache fill level.  Returns (logits [B, vocab], caches), the caches
    written in place."""
    logits, caches, _ = forward(cfg, params, tokens, mode="decode",
                                caches=caches, pos=pos)
    return logits[:, -1], caches


def fresh_decode_state(cfg, batch: int, max_len: int, device="cuda"):
    """Zeroed caches + pos for decode-from-scratch."""
    return init_cache(cfg, batch, max_len, device=device), 0


def greedy_generate(cfg, params, prompt, steps: int, max_len: int):
    """Tiny autoregressive driver used by examples/tests."""
    logits, caches, pos = prefill(cfg, params, prompt, max_len)
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    for _ in range(steps - 1):
        logits, caches = serve_step(cfg, params, caches, tok, pos)
        pos = pos + 1
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
