"""hubert-xlarge [audio] -- 48L d_model=1280 16H d_ff=5120 vocab=504,
encoder-only (bidirectional attention; same backbone as wav2vec2-XL).
[arXiv:2106.07447; unverified]

Per the assignment, the modality frontend (the 7-layer strided conv feature
extractor) is a STUB: ``input_specs()`` feeds precomputed 512-d frame
embeddings; the model projects them into d_model.  Encoder-only => no decode
step exists; decode_32k and long_500k are skipped (DESIGN.md §4).  The
504-way head is the HuBERT k-means target codebook.
"""

from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    pattern=(LayerSpec("attn", "gelu"),),
    causal=False,
    encoder_only=True,
    norm="layernorm",
    rope="rope",                   # stand-in for conv positional embedding
    rope_theta=10000.0,
    frontend="audio",
    frontend_dim=512,
    source="[arXiv:2106.07447; unverified]",
)
