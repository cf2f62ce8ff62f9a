"""qwen2-vl-7b [vlm] -- 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE (temporal/height/width rotary sections), dynamic
resolution.  [arXiv:2409.12191; hf]

Per the assignment this is the transformer BACKBONE; the vision tower is a
STUB -- ``input_specs()`` provides pre-merged patch+text embeddings plus the
[3, B, S] M-RoPE position streams (equal streams reduce M-RoPE to RoPE for
text tokens, exactly as in the paper)."""

from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    pattern=(LayerSpec("attn", "swiglu"),),
    rope="mrope",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    frontend_dim=3584,
    source="[arXiv:2409.12191; hf]",
)
