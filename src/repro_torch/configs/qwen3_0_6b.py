"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf-verified].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936 — qk_norm, GQA.
Qwen3 uses explicit head_dim=128 (q proj is 16*128 = 2048 > d_model) and
tied embeddings at this scale.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    layer_pattern="G",
)
