"""qwen2-moe-a2.7b [moe] -- 24L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408
vocab=151936, 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from .base import LayerSpec, MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,                    # shared-expert aggregate width
    vocab=151936,
    pattern=(LayerSpec("attn", "moe"),),
    moe=MoECfg(n_routed=60, top_k=4, n_shared=4, d_ff_expert=1408),
    rope_theta=1000000.0,
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)
