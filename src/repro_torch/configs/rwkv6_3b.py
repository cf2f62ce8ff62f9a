"""rwkv6-3b [ssm] -- 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536,
Finch: data-dependent per-channel decay, token-shift LoRA mixes, wkv state.
[arXiv:2404.05892; hf]

head_dim 64 => 40 wkv heads; O(1) recurrent state per layer (H x 64 x 64
matrix + token-shift vectors), so every decode shape including long_500k is a
constant-memory step.  No positional encoding (recurrence encodes order).
"""

from .base import LayerSpec, ModelConfig, RWKVCfg

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                    # wkv heads = d_model / head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    pattern=(LayerSpec("rwkv6", "rwkv_ffn"),),
    rwkv=RWKVCfg(head_dim=64),
    rope="none",
    norm="layernorm",
    source="[arXiv:2404.05892; hf]",
)
