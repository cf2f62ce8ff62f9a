"""gemma3-4b [dense] -- 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local(sliding-window 1024):global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

34 layers = 4 local prefix + 5 x (4 local + 1 global + 1 local) -- i.e. the
repeating unit is 5 local : 1 global; the remainder lives in the prefix.
The sliding-window layers keep ring-buffer caches of length 1024, which is
why this arch stays in the long_500k cell (DESIGN.md §4).
"""

from .base import LayerSpec, ModelConfig

_LOCAL = LayerSpec("swa", "swiglu", window=1024)
_GLOBAL = LayerSpec("attn", "swiglu")

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    prefix=(_LOCAL, _LOCAL, _LOCAL, _LOCAL),
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="[hf:google/gemma-3-1b-pt; unverified]",
)
