"""deepseek-v2-lite-16b [moe] -- 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed top-6 experts.
[arXiv:2405.04434; hf]  (The assignment line lists both "64e top-6" and
"160 routed"; 160 routed belongs to full V2 -- V2-*Lite* is 64 routed, top-6,
2 shared, which is what we implement.)  Layer 0 uses a dense SwiGLU MLP
(d_ff=10944) per the HF config; layers 1..26 are MoE.  MLA's compressed
per-token cache (512+64 floats/layer, head-count independent) is what makes
the long_500k decode cell feasible for this arch (DESIGN.md §4).
"""

from .base import LayerSpec, MLACfg, MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,                 # qk_nope(128) + qk_rope(64)
    d_ff=10944,                   # dense layer-0 MLP width
    vocab=102400,
    prefix=(LayerSpec("mla", "swiglu"),),
    pattern=(LayerSpec("mla", "moe"),),
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=None,
               qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(n_routed=64, top_k=6, n_shared=2, d_ff_expert=1408),
    rope_theta=10000.0,
    source="[arXiv:2405.04434; hf]",
)
