"""Serving substrate: prefill/decode steps + TTL-driven KV tier manager."""

from .decode import fresh_decode_state, greedy_generate, grow_cache, prefill, serve_step  # noqa: F401
