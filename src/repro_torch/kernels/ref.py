"""Plain PyTorch versions of the port's kernels.

Each function here computes what one hand-written kernel computes, in the
most obvious way -- no tiling, no streaming -- so it is easy to audit.  The
TTL-scan kernel's is in two parts: the surface (:func:`ttl_cost_ref`) and
the decision taken from it (:func:`ttl_decision_ref`).  :func:`rwkv6_ref`
is the reference's oracle of the RWKV6 recurrence, which has no kernel.
The kernel wrappers
use them for tensors that lie on the CPU, the CPU tests hold them against
the JAX reference, and ``chip_smoke.py`` holds each kernel against its plain
version on the card.
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
    TTL=0 is :func:`ttl_decision_ref`'s).  Works in the inputs' dtype.
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


#: Relative band for canonicalizing float32 argmin ties.  Exact cost-tie
#: plateaus exist in real surfaces (zero misses and zero censored tail beyond
#: a cell make consecutive candidates *exactly* equal in float64); float32
#: rounding wobble can then move a plain argmin off the plateau start.  Any
#: band in 2**-22 .. 2**-18 recovers the float64 plateau-start index on the
#: replay-harvested corpus; 2**-20 sits in the middle of that range.
TIE_BAND = 2.0 ** -20


def canonical_argmin(surface: torch.Tensor) -> torch.Tensor:
    """First index within ``TIE_BAND`` of each row minimum, in float64 on the
    CPU: int64 ``[E]``.

    This is the decision rule every float32 engine shares so that the chosen
    *index* -- and therefore the float64 candidate TTL it maps to -- matches
    the pure-float64 ``choose_ttl`` argmin even on exact-tie plateaus.  The
    kernel's epilogue takes the same rule on its own float32 values.
    (``torch.argmax`` takes no bool tensor; on the cast mask it returns the
    first maximal index, as ``np.argmax`` does.)
    """
    surf = surface.to(device="cpu", dtype=torch.float64)
    mn = surf.min(dim=1, keepdim=True).values
    return torch.argmax((surf <= mn * (1.0 + TIE_BAND)).to(torch.uint8), dim=1)


def ttl_decision_ref(hist, time_w, last, edges, s_price, n_price,
                     first_remote):
    """The plain version of the kernel's decision: ``(idx [E] int64 on the
    CPU, best [E], zero [E], surface [E, C])``, the last three in the inputs'
    dtype and where they lie.

    ``zero`` is the TTL = 0 cost (every re-read pays N; no storage at all),
    ``idx`` the canonical argmin of ``[zero, surface]`` (0 is TTL = 0, j + 1
    is ``edges[j]``) and ``best`` the cost there.  ``hist``, ``time_w`` and
    ``last`` may be one row ``[1, C]`` shared by every edge row.
    """
    surface = ttl_cost_ref(hist, time_w, last, edges, s_price, n_price,
                           first_remote)
    zero = (first_remote + hist.sum(dim=1)) * n_price
    full = torch.cat([zero[:, None], surface], dim=1)
    idx = canonical_argmin(full)
    best = full.gather(1, idx.to(full.device)[:, None])[:, 0]
    return idx, best, zero, surface


def mha_ref(
    q: torch.Tensor,             # [B, H, Sq, D]
    k: torch.Tensor,             # [B, H, Skv, D]
    v: torch.Tensor,             # [B, H, Skv, D]
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
    window: int | None = None,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Plain softmax attention in fp32, output in q's dtype.  ``q_offset``
    positions q in the kv timeline (decode: q_offset = kv_len - q_len).
    Key ``kpos`` is live for the query at ``qpos`` if ``kpos <= qpos`` when
    causal, ``kpos > qpos - window`` with a window, and ``kpos < kv_len``
    with a key count; a row with no live key gives zeros, as the kernels'
    streaming softmax does."""
    sq, d = q.shape[-2], q.shape[-1]
    skv = k.shape[-2]
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    dead = torch.zeros((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        dead |= kpos > qpos
    if window is not None:
        dead |= kpos <= qpos - window
    if kv_len is not None:
        dead |= kpos >= kv_len
    logits = logits.masked_fill(dead, float("-inf"))
    probs = torch.softmax(logits, dim=-1).nan_to_num(nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def rwkv6_ref(
    r: torch.Tensor,             # [B, H, T, K] receptance
    k: torch.Tensor,             # [B, H, T, K] key
    v: torch.Tensor,             # [B, H, T, V] value
    w: torch.Tensor,             # [B, H, T, K] per-step decay (0 < w < 1)
    u: torch.Tensor,             # [H, K]       bonus for the current token
    state: torch.Tensor | None = None,   # [B, H, K, V]
) -> tuple:
    """Finch recurrence (arXiv:2404.05892), one step at a time in fp32:
        S_t = diag(w_t) S_{t-1} + k_t^T v_t
        o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    Returns (out [B,H,T,V], final state [B,H,K,V]).  No kernel computes
    it, in either package: the recurrence is a plain scan.
    """
    B, H, T, K = r.shape
    V = v.shape[-1]
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    s = (r.new_zeros((B, H, K, V)) if state is None else state.float())
    outs = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]      # [B,H,K,V]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                                 s + u[None, :, :, None] * kv))
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(outs, dim=2), s
