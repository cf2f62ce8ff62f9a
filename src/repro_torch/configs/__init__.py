"""Architecture registry: one module per assigned architecture (``--arch``).

>>> from repro_torch.configs import get_config, ARCH_NAMES
>>> cfg = get_config("llama3.2-1b")
>>> small = cfg.reduced()          # CPU smoke-test variant
"""

from .base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    LayerSpec,
    MLACfg,
    MambaCfg,
    ModelConfig,
    MoECfg,
    RWKVCfg,
    ShapeConfig,
    YarnCfg,
)
from . import (
    deepseek_coder_33b,
    deepseek_v2_lite_16b,
    gemma3_4b,
    hubert_xlarge,
    jamba_v01_52b,
    llama32_1b,
    nemotron_4_340b,
    qwen2_moe_a27b,
    qwen2_vl_7b,
    rwkv6_3b,
)

_MODULES = (
    deepseek_v2_lite_16b,
    qwen2_moe_a27b,
    deepseek_coder_33b,
    nemotron_4_340b,
    llama32_1b,
    gemma3_4b,
    jamba_v01_52b,
    rwkv6_3b,
    hubert_xlarge,
    qwen2_vl_7b,
)

CONFIGS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_NAMES = tuple(CONFIGS)
SHAPE_NAMES = tuple(s.name for s in ALL_SHAPES)
SHAPES = {s.name: s for s in ALL_SHAPES}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return CONFIGS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {SHAPE_NAMES}")
    return SHAPES[name]


# ---------------------------------------------------------------------------
# Cell validity (DESIGN.md §4 skips)
# ---------------------------------------------------------------------------

#: Archs with a sub-quadratic / compressed path for the 500k-token cache.
LONG_CONTEXT_OK = frozenset({
    "rwkv6-3b",                # O(1) recurrent state
    "jamba-v0.1-52b",          # Mamba majority, attn 1:7
    "gemma3-4b",               # 5:1 sliding-window(1024):global
    "deepseek-v2-lite-16b",    # MLA compressed KV (576 floats/token/layer)
})


def cell_is_valid(arch: str, shape: str) -> tuple[bool, str]:
    """(valid, reason-if-skipped) for one (architecture x shape) cell."""
    cfg = get_config(arch)
    if cfg.encoder_only and shape in ("decode_32k", "long_500k"):
        return False, "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "pure full attention: no sub-quadratic 500k path"
    return True, ""


def valid_cells():
    return [
        (a, s)
        for a in ARCH_NAMES
        for s in SHAPE_NAMES
        if cell_is_valid(a, s)[0]
    ]
