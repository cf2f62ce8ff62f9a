"""Model/shape configuration schema for the assigned architecture pool.

A :class:`ModelConfig` fully describes one architecture as a *pattern* of
heterogeneous layers (attention / sliding-window attention / MLA / Mamba /
RWKV6 mixers x dense / MoE MLPs) repeated over depth -- this is what lets one
transformer stack serve dense llama-family models, DeepSeek MLA+MoE, Jamba's
1:7 attn:mamba interleave and RWKV6 alike.

Shapes (train_4k / prefill_32k / decode_32k / long_500k) are
:class:`ShapeConfig` instances; ``input_kind`` distinguishes training vs
prefill vs single-token decode lowering.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_routed: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0          # per-expert hidden; 0 = use model d_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 = ceil(d_model / 16)
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    chunk: int = 16        # pairwise intra-chunk decay is [B,H,Q,Q,K]: keep Q small
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating depth pattern."""

    mixer: str                     # attn | swa | mla | mamba | rwkv6
    mlp: str                       # swiglu | relu2 | gelu | moe
    window: Optional[int] = None   # for swa


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...]                 # repeated to fill n_layers
    prefix: Tuple[LayerSpec, ...] = ()             # irregular leading layers
    head_dim: int = 0                              # 0 = d_model // n_heads
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    rwkv: Optional[RWKVCfg] = None
    rope: str = "rope"             # rope | mrope | none
    rope_theta: float = 500000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    causal: bool = True
    encoder_only: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    frontend: Optional[str] = None  # None | audio | vision
    frontend_dim: int = 0           # stub frontend feature dim
    logit_softcap: float = 0.0
    optimizer: str = "adamw"        # adamw | adafactor (chosen to fit HBM)
    pure_bf16: bool = False         # no fp32 master copy (stochastic-rounding
    # recipe for 100B+ models; see configs/nemotron_4_340b.py)
    remat_policy: str = "nothing"   # nothing | dots  (activation remat: full
    # recompute vs save matmul outputs -- trades HBM for FSDP re-gathers)
    microbatches_train: int = 0     # grad-accum override (0 = size heuristic)
    source: str = ""                # provenance note ([arXiv/hf; tier])

    # ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layers(self) -> Tuple[LayerSpec, ...]:
        """The full depth-wise layer list (prefix + repeated pattern)."""
        body = self.n_layers - len(self.prefix)
        reps = math.ceil(body / len(self.pattern))
        seq = self.prefix + tuple(
            self.pattern[i % len(self.pattern)] for i in range(body)
        )
        assert len(seq) == self.n_layers, (len(seq), self.n_layers)
        return seq

    def pattern_repeats(self) -> int:
        body = self.n_layers - len(self.prefix)
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {body} body layers not divisible by pattern "
            f"{len(self.pattern)}"
        )
        return body // len(self.pattern)

    # -- parameter counting (used by the roofline's MODEL_FLOPS = 6*N*D) -----
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for spec in self.layers():
            if spec.mixer in ("attn", "swa"):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
            elif spec.mixer == "mla":
                m = self.mla
                qdim = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                total += d * qdim                                   # q proj
                total += d * (m.kv_lora_rank + m.qk_rope_dim)        # down
                total += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_dim + m.v_head_dim)                    # up
                total += self.n_heads * m.v_head_dim * d             # o
            elif spec.mixer == "mamba":
                c = self.mamba
                d_in = c.expand * d
                dt_rank = c.dt_rank or -(-d // 16)
                total += d * 2 * d_in                                # in_proj
                total += d_in * c.d_conv                             # conv
                total += d_in * (dt_rank + 2 * c.d_state)            # x_proj
                total += dt_rank * d_in + d_in                       # dt_proj
                total += d_in * c.d_state * 2                        # A, D-ish
                total += d_in * d                                    # out
            elif spec.mixer == "rwkv6":
                c = self.rwkv
                h = d // c.head_dim
                total += 4 * d * d + d * d                           # r,k,v,g,o
                total += d * c.decay_lora * 2 + 6 * d * c.mix_lora * 2
                total += h * c.head_dim * 2                          # u, base decay
            if spec.mlp == "moe":
                m = self.moe
                dff = m.d_ff_expert or self.d_ff
                shared = m.n_shared * 3 * d * dff
                routed = m.n_routed * 3 * d * dff
                router = d * m.n_routed
                if active_only:
                    routed = m.top_k * 3 * d * dff
                total += shared + routed + router
            else:
                mult = 3 if spec.mlp == "swiglu" else 2
                total += mult * d * self.d_ff
            total += 2 * d                                           # norms
        return total

    # -- reduced config for CPU smoke tests -------------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family/pattern, tiny dims: one pattern repeat, 2-64 dims."""
        hd = 8
        n_heads = max(2, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        moe = self.moe and dataclasses.replace(
            self.moe, n_routed=min(self.moe.n_routed, 8),
            top_k=min(self.moe.top_k, 2), n_shared=min(self.moe.n_shared, 1),
            d_ff_expert=32 if self.moe.d_ff_expert else 0,
            # generous capacity so prefill/decode consistency tests see no
            # capacity drops (dropping asymmetry is inherent to GShard-style
            # dispatch, not a bug -- see apply_moe)
            capacity_factor=8.0,
        )
        mla = self.mla and MLACfg(kv_lora_rank=16, q_lora_rank=None,
                                  qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8)
        mamba = self.mamba and dataclasses.replace(
            self.mamba, d_state=4, d_conv=4, expand=2, dt_rank=4, chunk=8)
        rwkv = self.rwkv and dataclasses.replace(
            self.rwkv, head_dim=8, chunk=8, decay_lora=8, mix_lora=4)
        pattern = tuple(
            dataclasses.replace(s, window=(8 if s.window else None))
            for s in self.pattern
        )
        prefix = tuple(
            dataclasses.replace(s, window=(8 if s.window else None))
            for s in self.prefix
        )
        half = hd // 2
        sections = (half - 2 * (half // 3), half // 3, half // 3)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=len(prefix) + len(pattern),
            mrope_sections=sections,
            d_model=n_heads * hd,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=64,
            vocab=256,
            pattern=pattern,
            prefix=prefix,
            moe=moe, mla=mla, mamba=mamba, rwkv=rwkv,
            frontend_dim=16 if self.frontend else 0,
            act_dtype="float32",
            param_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    input_kind: str                # train | prefill | decode
    microbatches: int = 1          # grad-accum steps (train only)


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
