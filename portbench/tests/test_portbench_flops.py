"""The yardstick's arithmetic equals hand counts."""

import json

import pytest
from conftest import BENCH

from pb import flops

QWEN = json.loads((BENCH / "configs" / "qwen2-moe-a2.7b.json").read_text())


def test_layer_flops_by_hand():
    d, f, fs = 2048, 1408, 5632
    by_hand = (2 * d * 128 * 16 * 4          # q, k, v, o
               + 2 * d * 60                  # router
               + 4 * 3 * 2 * d * f           # 4 routed experts
               + 3 * 2 * d * fs)             # the shared expert
    assert flops.layer_flops_per_token(QWEN) == by_hand == 172_212_224


def test_prefill_and_decode_flops_by_hand():
    per_tok = 172_212_224
    head = 2 * 2048 * 151936
    length = 1000
    pairs = length * (length + 1) // 2
    want = 4 * (length * 24 * per_tok + 24 * 4 * 16 * 128 * pairs + head)
    assert flops.prefill_flops(QWEN, 4, length) == want
    want = 4 * (24 * (per_tok + 4 * 16 * 128 * 1001) + head)
    assert flops.decode_flops(QWEN, 4, 1000) == want


def test_attention_bound_by_hand():
    # Decode: one query row per sequence and head, 1001 live keys of a
    # 2080-deep cache: bound by the bytes of K and V.
    s = flops.attn_bound_s(b=4, hq=16, hkv=16, sq=1, skv=2080, d=128,
                           causal=False, q_offset=1000, kv_len=1001)
    n_bytes = 2 * (2 * 4 * 16 * 1 * 128 + 2 * 4 * 16 * 1001 * 128)
    assert s == pytest.approx(n_bytes / 3.35e12, rel=1e-12)
    # Causal prefill of 1024 at D 128: Q, K, V and O once (bytes) against
    # the causal pairs' operations; at this size the bytes bound it.
    s = flops.attn_bound_s(b=4, hq=16, hkv=16, sq=1024, skv=1024, d=128,
                           causal=True, q_offset=0)
    ops = 4 * 4 * 16 * (1024 * 1025 // 2) * 128
    n_bytes = 2 * (4 * 4 * 16 * 1024 * 128)
    assert s == pytest.approx(max(ops / 989e12, n_bytes / 3.35e12), rel=1e-12)
    assert n_bytes / 3.35e12 > ops / 989e12
    # A sliding window of 256 over 1024 causal rows.
    s = flops.attn_bound_s(b=1, hq=1, hkv=1, sq=1024, skv=1024, d=64,
                           causal=True, q_offset=0, window=256)
    pairs = sum(min(i + 1, 256) for i in range(1024))
    assert s == pytest.approx(max(4 * pairs * 64 / 989e12,
                                  2 * (2 * 1024 * 64 * 2) / 3.35e12), rel=1e-12)
