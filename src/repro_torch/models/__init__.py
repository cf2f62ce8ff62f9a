"""The model stack (the port of ``repro.models``): llama-style decoders,
sliding-window layers, M-RoPE, encoder-only stacks, MLA, MoE, Mamba and
RWKV6."""

from .transformer import (  # noqa: F401
    cache_schema,
    cross_entropy,
    forward,
    init_cache,
    init_params,
    loss_fn,
    model_schema,
    params_from_reference,
)
