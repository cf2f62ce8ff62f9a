"""Plain PyTorch versions of the port's kernels.

Each function here computes what one hand-written kernel computes, in the
most obvious way -- no tiling, no streaming -- so it is easy to audit.  The
kernel wrappers use them for tensors that lie on the CPU, the CPU tests hold
them against the JAX reference, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""

from __future__ import annotations

import torch


def ttl_cost_ref(
    hist: torch.Tensor,          # [E, C] bytes re-read per cell (float32)
    time_w: torch.Tensor,        # [E, C] sum(gap * bytes) per cell
    last: torch.Tensor,          # [E, C] paused-bytes census per age cell
    edges: torch.Tensor,         # [C]    cell upper boundaries (seconds)
    s_price: torch.Tensor,       # [E]    storage $ / (byte * second) at the target
    n_price: torch.Tensor,       # [E]    egress  $ / byte on the edge
    first_remote: torch.Tensor,  # [E]    bytes whose initial GET was remote
) -> torch.Tensor:
    """ExpectedCost(TTL=edges[j]) for every edge and candidate: [E, C].

    Mirrors :func:`repro_torch.core.ttl_policy.expected_cost_curve` (candidate
    TTL=0 is handled by the wrapper, not here).  Works in the inputs' dtype.
    """
    e = edges[None, :]
    s = s_price[:, None]
    n = n_price[:, None]
    lower = torch.cat([edges.new_zeros(1), edges[:-1]])
    mid = (0.5 * (lower + edges))[None, :]

    t_hat = torch.where(hist > 0, time_w / hist.clamp_min(1e-30), mid)
    hit_csum = torch.cumsum(hist * t_hat, dim=1)
    hist_csum = torch.cumsum(hist, dim=1)
    last_csum = torch.cumsum(last, dim=1)
    age_csum = torch.cumsum(last * mid, dim=1)
    total_hist = hist_csum[:, -1:]
    total_last = last_csum[:, -1:]

    miss = total_hist - hist_csum
    tail = total_last - last_csum
    return (
        first_remote[:, None] * n
        + s * hit_csum
        + miss * (n + e * s)
        + tail * e * s
        + s * age_csum
    )


def mha_ref(
    q: torch.Tensor,             # [B, H, Sq, D]
    k: torch.Tensor,             # [B, H, Skv, D]
    v: torch.Tensor,             # [B, H, Skv, D]
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain softmax attention in fp32, output in q's dtype.  ``q_offset``
    positions q in the kv timeline (decode: q_offset = kv_len - q_len)."""
    sq, d = q.shape[-2], q.shape[-1]
    skv = k.shape[-2]
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
