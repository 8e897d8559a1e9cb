"""Whisper-base [arXiv:2212.04356; unverified tier].

6L d_model=512 8H d_ff=2048 vocab=51865 — encoder-decoder backbone
(6 encoder + 6 decoder layers), LayerNorm + GELU, absolute sinusoidal
positions (no rope), conv audio frontend STUBBED per the assignment:
input_specs() provides precomputed frame embeddings. The real frontend
math (log-mel STFT) is the paper's own workload and lives in
core/spectral.py (see examples/spectral_analysis.py).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    frontend="audio_frames",
    cross_len=1500,
    tie_embeddings=True,
    layer_pattern="G",
)
