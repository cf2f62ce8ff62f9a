"""The yardstick of MLA's decode attention: the least time of one call of
the port's ``kernels.mla_decode`` (one query token a sequence, all heads
scored in latent space against the ``kv_len`` cache rows written so far).

Each latent row serves every head: 2 x heads x (R + rope + R) FLOP a row
against (R + rope) x 2 bytes, about 30 FLOP a byte at deepseek's widths,
below the card's 295 for bf16.  So the bound is the bytes: every cache row
up to ``kv_len`` read once (``ckv`` and ``krope``), the queries read and
the output written once, over the HBM rate.  At B 4, 16 heads, R 512,
rope 64 and ``kv_len`` 16,447: 75.8 MB, 22.6 us.
"""

from __future__ import annotations

from .flops import BF16_FLOPS, HBM_BYTES


def mla_decode_bytes(b: int, heads: int, kv_len: int, latent: int = 512,
                     rope: int = 64, item: int = 2) -> int:
    """Bytes one call needs to move: the rows, ``q`` (latent + rope a
    head) and ``o`` (latent a head)."""
    return item * b * (kv_len * (latent + rope) + heads * (latent + rope)
                       + heads * latent)


def mla_decode_flops(b: int, heads: int, kv_len: int, latent: int = 512,
                     rope: int = 64) -> int:
    """Scores and p . ckv over every (head, row) pair."""
    return 2 * b * heads * kv_len * (latent + rope + latent)


def mla_decode_bound_s(b: int, heads: int, kv_len: int, latent: int = 512,
                       rope: int = 64, item: int = 2) -> float:
    """Least seconds of one call: the larger of its bytes over the HBM
    rate and its FLOPs over the bf16 peak."""
    return max(mla_decode_bytes(b, heads, kv_len, latent, rope, item) / HBM_BYTES,
               mla_decode_flops(b, heads, kv_len, latent, rope) / BF16_FLOPS)
