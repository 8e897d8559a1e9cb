"""Zamba2-7B [arXiv:2411.15242; unverified tier].

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64 —
Mamba2 backbone with a SHARED full-attention transformer block applied
every 6th layer (13 applications, one set of weights): pattern "MMMMMS"
with 81 = 13*6 + 3 (tail = 3 mamba layers). The shared block's params are
scan-closure constants; its 13 KV caches are per-period scan xs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    layer_pattern="MMMMMS",
)
