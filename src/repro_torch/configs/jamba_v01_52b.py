"""jamba-v0.1-52b [hybrid] -- 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]

Repeating 8-layer Jamba block: attention at offset 4, Mamba elsewhere; MoE
replaces the dense MLP at odd offsets (arXiv:2403.19887 §3: a=1/8, e=1/2).
Mamba layers carry O(1) conv+ssm state, attention layers 1:7 -- which is what
keeps the long_500k decode cell affordable for this arch.
"""

from .base import LayerSpec, MambaCfg, MoECfg, ModelConfig

_M_D = LayerSpec("mamba", "swiglu")
_M_E = LayerSpec("mamba", "moe")
_A_E = LayerSpec("attn", "moe")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=(_M_D, _M_E, _M_D, _M_E, _A_E, _M_E, _M_D, _M_E),
    moe=MoECfg(n_routed=16, top_k=2, n_shared=0, d_ff_expert=14336),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    rope_theta=10000.0,
    source="[arXiv:2403.19887; hf]",
)
