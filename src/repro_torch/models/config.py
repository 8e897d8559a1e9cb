"""Model configuration schema shared by all 10 assigned architectures."""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None       # None -> d_model // num_heads

    # --- attention features ---
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int | None = None   # SWA width (None = full attention)
    layer_pattern: str = "G"            # repeating unit: G=global, L=local(SWA),
                                        # M=mamba2, R=rwkv6, S=shared-attn(zamba)
    rope_theta: float = 10_000.0
    rope_theta_local: float | None = None   # gemma3: local layers use 10k
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    post_norms: bool = False            # gemma3 sandwich norms
    embed_scale: bool = False           # gemma: h *= sqrt(d_model)
    tie_embeddings: bool = False
    act: str = "silu"                   # silu | gelu
    norm_eps: float = 1e-6

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    shared_expert: bool = False         # llama4: always-on shared expert
    capacity_factor: float = 1.25
    moe_impl: str = "tp"                # tp | ep  (ep = expert-parallel a2a)
    moe_force_weight_gather: bool = False  # kill d-contraction partial ARs
                                        # by gathering expert weights instead

    # --- SSM / linear attention ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    cross_len: int = 1500               # whisper: 30s of frames

    # --- frontends (stubs per spec) ---
    frontend: str | None = None         # audio_frames | vision_patches
    num_prefix_embeds: int = 0          # vlm: vision patches

    # --- numerics / training ---
    dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    remat: str = "full"                 # none | full
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 512
    loss_chunk: int = 512        # seq-chunked cross-entropy head
    moe_group_size: int = 2048          # tokens per MoE dispatch group

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return all(c in "MR" for c in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if long_500k is runnable: SSM/hybrid state, SWA ring caches,
        or shared-attn hybrid (zamba2 — spec: run for SSM/hybrid)."""
        return all(c in "MRS" or (c == "L" and self.sliding_window)
                   for c in self.layer_pattern)

    def layer_kinds(self) -> list[str]:
        """Expanded per-layer kind string of length num_layers."""
        pat = self.layer_pattern
        return [pat[i % len(pat)] for i in range(self.num_layers)]

    def pattern_groups(self) -> tuple[int, int]:
        """(full_periods, tail_layers) when scanning by pattern period."""
        period = len(self.layer_pattern)
        return self.num_layers // period, self.num_layers % period

    def n_params(self) -> float:
        """Approximate parameter count (embedding + blocks), for 6ND."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, kv = self.head_dim, self.num_heads, self.num_kv_heads
        per_attn = d * hd * (h + 2 * kv) + h * hd * d
        if self.num_experts:
            per_mlp = 3 * d * ff * self.num_experts + d * self.num_experts
            if self.shared_expert:
                per_mlp += 3 * d * ff
        else:
            per_mlp = 3 * d * ff
        d_in = self.ssm_expand * d
        per_ssm = d * (2 * d_in + 2 * self.ssm_state
                       + d_in // self.ssm_head_dim) + d_in * d
        per_rwkv = 4 * d * d + d * d + 2 * d * ff  # time-mix + channel-mix
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind in "GLS":
                total += per_attn + per_mlp
            elif kind == "M":
                total += per_ssm
            elif kind == "R":
                total += per_rwkv
        total += self.encoder_layers * (per_attn + per_mlp)
        if self.encoder_layers:  # decoder cross-attention
            total += self.num_layers * per_attn
        return float(total)

    def n_active_params(self) -> float:
        """Active params per token (MoE: routed top-k + shared)."""
        if not self.num_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dense_moe = 3 * d * ff * self.num_experts
        active = 3 * d * ff * (self.num_experts_per_tok
                               + (1 if self.shared_expert else 0))
        n_moe_layers = sum(1 for k in self.layer_kinds() if k in "GLS")
        return self.n_params() - n_moe_layers * (dense_moe - active)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = len(self.layer_pattern)
        small = dict(
            num_layers=max(2, min(2 * period, 6)),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            cross_len=16 if self.encoder_layers else 1500,
            num_prefix_embeds=8 if self.num_prefix_embeds else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            attn_q_chunk=64,
            attn_kv_chunk=32,
            loss_chunk=32,
            cache_dtype="float32",
            moe_group_size=64,
            dtype="float32",
            remat="none",
        )
        small.update(overrides)
        return replace(self, **small)
