"""Gradient compression for cross-pod reduction: int8 block quantization.

The port of ``repro.distributed.compression``.  Each leaf is quantized with
a per-tensor scale from its fp32 absmax, as a quantize -> (all-reduce over
the pod axis) -> dequantize sandwich; on one card there is no all-reduce,
and the train step sees the dequantized gradients, so the compression error
is modelled exactly.  Error feedback carries the quantization residual into
the next step.  The clip and cast order is the reference's, and
``torch.round`` rounds half to even as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import tree_map


def _absmax_scale(g: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(g.abs().max(), 1e-12) / 127.0


def compress_grads_int8(grads: Any) -> Tuple[Any, Any]:
    """tree of fp grads -> (int8 tree, fp32 scale tree)."""
    scales = tree_map(lambda g: _absmax_scale(g.float()), grads)
    q = tree_map(
        lambda g, s: torch.clamp(torch.round(g.float() / s), -127, 127)
        .to(torch.int8),
        grads, scales)
    return q, scales


def decompress_grads_int8(q: Any, scales: Any) -> Any:
    return tree_map(lambda qi, s: qi.float() * s, q, scales)


def compress_with_error_feedback(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """(grads + residual) -> (dequantized grads, new residual)."""
    if residual is not None:
        grads = tree_map(lambda g, r: g.float() + r, grads, residual)
    q, s = compress_grads_int8(grads)
    deq = decompress_grads_int8(q, s)
    new_residual = tree_map(lambda g, d: g.float() - d, grads, deq)
    return deq, new_residual


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
