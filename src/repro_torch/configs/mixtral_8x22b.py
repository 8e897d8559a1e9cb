"""Mixtral-8x22B [arXiv:2401.04088; hf-verified].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8 experts
top-2, sliding-window attention (per the assigned config) window 4096.
Pure-SWA decode => long_500k runs with an O(window) ring cache.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    layer_pattern="L",
    rope_theta=1_000_000.0,
)
