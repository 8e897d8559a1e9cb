"""RWKV6 "Finch" time-mix block (arXiv:2404.05892), the JAX package's
block in torch ops.

Data-dependent decay w_t = exp(-exp(base + LoRA(x_shift))) feeding the
chunked linear-attention core, token-shift lerps, a per-head bonus u, a
grouped output norm and output gating. As in the reference, the r/k/v/g
token-shift mixes are static learned lerps (Finch also LoRA-modulates
them); the decay path is the released model's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _pad_seq
from repro_torch.models.linear_attn import chunked_gla, step_gla
from repro_torch.models.mlp import _token_shift
from repro_torch.sharding.rules import ParamSpec

DECAY_LORA = 64


def rwkv_tmix_specs(cfg, stacked: tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    dk = d // h
    pre = tuple("layers" for _ in stacked)

    def mat(shape, axes, **kw):
        return ParamSpec(stacked + shape, pre + axes, **kw)

    return {
        "mu_r": mat((d,), ("d_model",), init="ones", scale=0.5),
        "mu_k": mat((d,), ("d_model",), init="ones", scale=0.5),
        "mu_v": mat((d,), ("d_model",), init="ones", scale=0.5),
        "mu_g": mat((d,), ("d_model",), init="ones", scale=0.5),
        "mu_w": mat((d,), ("d_model",), init="ones", scale=0.5),
        "wr": mat((d, h, dk), ("d_model", "heads", "head_dim")),
        "wk": mat((d, h, dk), ("d_model", "heads", "head_dim")),
        "wv": mat((d, h, dk), ("d_model", "heads", "head_dim")),
        "wg": mat((d, d), ("d_model", "d_model")),
        "wo": mat((h, dk, d), ("heads", "head_dim", "d_model")),
        "w_base": mat((h, dk), ("heads", "head_dim"), init="zeros"),
        "w_lora_a": mat((d, DECAY_LORA), ("d_model", None)),
        "w_lora_b": mat((DECAY_LORA, h, dk), (None, "heads", "head_dim"),
                        init="zeros"),
        "u": mat((h, dk), ("heads", "head_dim"), init="zeros"),
        "ln_scale": mat((h, dk), ("heads", "head_dim"), init="ones"),
        "ln_bias": mat((h, dk), ("heads", "head_dim"), init="zeros"),
    }


def _head_groupnorm(o, scale, bias, eps=64e-5):
    """RWKV GroupNorm(H): normalize each head's dk channels, in float32."""
    f = o.float()
    mu = f.mean(-1, keepdim=True)
    var = ((f - mu) ** 2).mean(-1, keepdim=True)
    y = (f - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(o.dtype)


def _lerp(p, mu, x, prev):
    m = p[mu].to(x.dtype)
    return x * m + prev * (1 - m)


def _gate(p, x, prev):
    """The output gate silu(lerp_g @ wg), (B,S,d)."""
    return F.silu(torch.matmul(_lerp(p, "mu_g", x, prev),
                               p["wg"].to(x.dtype)))


def _mix_proj(cfg, p, x, prev):
    """(r, k, v, logw) of the heads ``p`` holds."""
    dt = x.dtype
    r = torch.einsum("bsd,dhk->bshk", _lerp(p, "mu_r", x, prev),
                     p["wr"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", _lerp(p, "mu_k", x, prev),
                     p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", _lerp(p, "mu_v", x, prev),
                     p["wv"].to(dt))
    # data-dependent decay: logw = -exp(base + lora(x_w)), always < 0
    lora = torch.matmul(_lerp(p, "mu_w", x, prev), p["w_lora_a"].to(dt))
    lora = torch.einsum("bsr,rhk->bshk", torch.tanh(lora),
                        p["w_lora_b"].to(dt))
    logw = -torch.exp(p["w_base"].float() + lora.float())
    return r, k, v, logw


def rwkv_tmix(cfg, p, x, carry=None, tp=None):
    """x (B,S,d) -> (y, new_carry). carry = (x_last (B,d), state (B,H,dk,dk)).

    S is padded to a multiple of 16 for the chunked scan (a padded step
    has log-decay 0 and zero k and v, so the final state is the one after
    the real steps) and the output cut back.

    With ``tp`` (a `ModelGroup`) and ``p`` holding this rank's block of
    the heads: the gate reads the whole ``wg`` outside the split region
    (inside it, its gradient would be summed over the ranks); ``x``
    enters the region, where ``wr``, ``wk``, ``wv`` and ``w_lora_b`` are
    column-parallel, the decay, bonus, scan and head norm are each
    head's own, and ``wo`` is row-parallel; ``tp.exit`` sums the output
    before the gate multiplies it, as the reference gates the sum. The
    lerps' ``mu_r``, ``mu_k``, ``mu_v``, ``mu_w`` and ``w_lora_a`` are
    read whole inside the region ("partial")."""
    s = x.shape[1]
    x_last, state = carry if carry is not None else (None, None)
    prev = _token_shift(x, x_last)
    g = _gate(p, x, prev)
    split = tp is not None and p["wr"].shape[-2] < cfg.num_heads
    if split:
        x = tp.enter(x)
        prev = _token_shift(x, x_last)
    r, k, v, logw = _mix_proj(cfg, p, x, prev)

    pad = (-s) % 16
    if pad:  # chunk alignment
        r, k, v, logw = (_pad_seq(a, pad) for a in (r, k, v, logw))
    o, state = chunked_gla(r, k, v, logw, u=p["u"], initial_state=state)
    o = o[:, :s]

    o = _head_groupnorm(o, p["ln_scale"], p["ln_bias"])
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if split:
        y = tp.exit(y)
    y = y * g.to(y.dtype)
    return y, (x[:, -1], state)


def rwkv_tmix_step(cfg, p, x, carry, tp=None):
    """Single-token decode. x (B,1,d); carry as in rwkv_tmix. With ``tp``
    and ``p`` holding this rank's block of the heads, as `rwkv_tmix`'s
    split path: the gate reads the whole ``wg`` outside the split region,
    the state is the rank's heads', and ``tp.exit`` sums ``wo``'s
    row-parallel output before the gate multiplies it."""
    x_last, state = carry
    prev = x_last[:, None] if x_last is not None else torch.zeros_like(x)
    g = _gate(p, x, prev)
    split = tp is not None and p["wr"].shape[-2] < cfg.num_heads
    if split:
        x = tp.enter(x)
    r, k, v, logw = _mix_proj(cfg, p, x, prev)
    o, state = step_gla(r, k, v, logw, p["u"], state)
    o = _head_groupnorm(o, p["ln_scale"], p["ln_bias"])
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if split:
        y = tp.exit(y)
    return y * g.to(y.dtype), (x[:, 0], state)


def rwkv_state_init(cfg, batch: int, dtype=torch.float32, device=None):
    """(x_last (B, d) in ``dtype``, state (B, H, dk, dk) in float32)."""
    h = cfg.num_heads
    dk = cfg.d_model // h
    return (torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            torch.zeros((batch, h, dk, dk), dtype=torch.float32,
                        device=device))
