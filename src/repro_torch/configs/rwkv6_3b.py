"""RWKV6 "Finch" 3B [arXiv:2404.05892; hf-verified].

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 — data-dependent
decay WKV with 40 heads of 64 (head_dim = 64 convention). The paper's FFT
technique is inapplicable to the data-dependent-decay mixer (DESIGN.md §5);
long_500k runs with O(1) recurrent state.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    layer_pattern="R",
)
