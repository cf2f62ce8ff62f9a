"""The yardstick's arithmetic: the card's peaks, a model's operations per
token, and the least time of one attention call.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W (dense,
no sparsity), as ``repro_torch.launch.mesh`` (``PEAK_FLOPS_BF16``,
``HBM_BW``) and ``chip_smoke.py`` state them.  ``attn_bound_s`` is a copy
of ``chip_smoke.flash_bound_ms``: copied, so that later changes to the
program cannot move it.
"""

from __future__ import annotations

BF16_FLOPS = 989e12        # FLOP/s, dense bf16 tensor cores
F32_FLOPS = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BYTES = 3.35e12        # B/s, HBM3


def attn_bound_s(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                 causal: bool, q_offset: int, dtype: str = "bfloat16",
                 window=None, kv_len=None) -> float:
    """Least seconds for one attention call: Q and O once, the K/V rows some
    query attends once, over the HBM rate; against 4 * D operations per
    attended (query, key) pair (two products) over the peak rate of the
    inputs' type.  A pair is attended if its key lies below ``kv_len``, at
    or before the query when causal, and inside the window."""
    top = skv if kv_len is None else min(skv, kv_len)
    pairs, lo_min, hi_max = 0, None, 0
    for i in range(sq):
        hi = min(top, q_offset + i + 1) if causal else top
        lo = max(0, q_offset + i - window + 1) if window else 0
        hi = max(lo, hi)
        pairs += hi - lo
        lo_min = lo if lo_min is None else min(lo_min, lo)
        hi_max = max(hi_max, hi)
    kv_rows = max(0, hi_max - (lo_min or 0))
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = item * (2 * b * hq * sq * d + 2 * b * hkv * kv_rows * d)
    rate = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    return max(n_bytes / HBM_BYTES, 4 * b * hq * pairs * d / rate)


def layer_flops_per_token(m: dict) -> float:
    """Matrix-product FLOPs of one decoder layer for one token, the
    attention core left out: q/k/v/o projections, the router, the routed
    experts a token uses (``num_experts_per_tok``), the shared expert."""
    d, hd = m["hidden_size"], m["head_dim"]
    h, kv = m["num_attention_heads"], m["num_key_value_heads"]
    proj = 2 * d * hd * (2 * h + 2 * kv)
    router = 2 * d * m["num_experts"]
    routed = m["num_experts_per_tok"] * 3 * 2 * d * m["moe_intermediate_size"]
    shared = 3 * 2 * d * m["shared_expert_intermediate_size"]
    return float(proj + router + routed + shared)


def attn_core_flops(m: dict, pairs: int) -> float:
    """Scores and P.V over ``pairs`` attended (query, key) pairs, all heads
    of one layer."""
    return 4.0 * m["num_attention_heads"] * m["head_dim"] * pairs


def head_flops(m: dict) -> float:
    return 2.0 * m["hidden_size"] * m["vocab_size"]


def prefill_flops(m: dict, batch: int, length: int) -> float:
    """What a prefill of ``batch`` prompts of ``length`` tokens needs: every
    layer for every token, attention at its causal pairs, the head at the
    last position of each prompt (the one whose logits are used)."""
    pairs = length * (length + 1) // 2
    per_seq = (length * m["num_hidden_layers"] * layer_flops_per_token(m)
               + m["num_hidden_layers"] * attn_core_flops(m, pairs)
               + head_flops(m))
    return batch * per_seq


def decode_flops(m: dict, batch: int, pos: int) -> float:
    """One decode step writing position ``pos`` (attending ``pos + 1``
    keys) for ``batch`` sequences."""
    per_seq = (m["num_hidden_layers"] * (layer_flops_per_token(m)
                                         + attn_core_flops(m, pos + 1))
               + head_flops(m))
    return batch * per_seq
