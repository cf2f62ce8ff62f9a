"""nemotron-4-340b [dense] -- 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP (no gating), RoPE.
[arXiv:2402.16819; unverified]

At 340B parameters this is the framework's HBM-pressure case.  The recipe
that fits 256 x 16 GB (EXPERIMENTS.md §Dry-run memory table): pure-bf16
parameters with NO fp32 master copy (pair with stochastic rounding on real
hardware), Adafactor's factored second moment, bf16 gradient accumulation,
16 grad-accum microbatches, and full activation remat.
"""

from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    pattern=(LayerSpec("attn", "relu2"),),
    rope_theta=10000.0,
    optimizer="adafactor",
    pure_bf16=True,
    remat_policy="dots",          # §Perf A2: -16% compute, -11% collectives
    microbatches_train=8,         # §Perf A1: -17% collectives, still fits
    source="[arXiv:2402.16819; unverified]",
)
