"""Gemma3-1B [hf:google/gemma-3-1b-pt; unverified tier].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 — 5:1 local:global
attention pattern (window 512 local layers, full-attention every 6th),
qk-norm, sandwich norms, GeGLU, head_dim=256, dual rope thetas
(10k local / 1M global), tied embeddings, sqrt(d) embedding scale.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    qk_norm=True,
    sliding_window=512,
    layer_pattern="LLLLLG",
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    act="gelu",
)
