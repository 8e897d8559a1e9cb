"""InternVL2-2B [arXiv:2404.16821; hf-verified].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 — InternLM2-1.8B
language backbone; InternViT vision tower STUBBED per the assignment:
input_specs() provides 256 precomputed patch embeddings prepended to the
token sequence (prefix-LM layout, loss masked over the prefix).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    num_prefix_embeds=256,
    layer_pattern="G",
)
