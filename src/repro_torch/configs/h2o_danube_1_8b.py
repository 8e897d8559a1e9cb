"""H2O-Danube-1.8B [arXiv:2401.16818; hf-verified].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 — llama+mistral mix
with sliding-window attention (mistral-style window 4096) on all layers.
Pure-SWA decode means long_500k runs with an O(window) ring cache.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    layer_pattern="L",
    rope_theta=10_000.0,
)
