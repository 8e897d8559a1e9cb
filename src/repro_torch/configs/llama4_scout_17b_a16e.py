"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 routed + always-on shared expert (llama4's MoE design). Text
backbone only per the assignment ("early fusion" multimodality not in
scope of the assigned shape set).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    num_experts_per_tok=1,
    shared_expert=True,
    rope_theta=500_000.0,
    layer_pattern="G",
)
