"""llama3.2-1b [dense] -- 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, small llama3 (SwiGLU, RoPE theta 500k, tied embeddings).
[hf:meta-llama/Llama-3.2-1B; unverified]
"""

from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    pattern=(LayerSpec("attn", "swiglu"),),
    rope_theta=500000.0,
    tie_embeddings=True,
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
)
