"""Shared model primitives: norms, RoPE, activations, losses."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import ParamSpec, constrain
from repro_torch.sharding.tensor_parallel import lse_and_gold


# ---------------------------------------------------------------------------
# norms


def rms_norm(x, scale, eps=1e-6, plus_one=False):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return (y * s).to(dt)


def layer_norm(x, scale, bias, eps=1e-6):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_apply(cfg, x, p):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    plus_one = cfg.post_norms  # gemma-style (1+w) scaling
    return rms_norm(x, p["scale"], cfg.norm_eps, plus_one=plus_one)


def norm_specs(cfg, stacked: tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    axes = tuple("layers" for _ in stacked)
    out = {"scale": ParamSpec(stacked + (d,), axes + ("d_model",),
                              init="zeros" if cfg.post_norms else "ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamSpec(stacked + (d,), axes + ("d_model",), init="zeros")
    return out


# ---------------------------------------------------------------------------
# rotary embeddings


def rope(x, positions, theta: float):
    """Apply rotary embedding. x: (..., S, H, hd); positions: (..., S).

    The frequencies are numpy float32, as the reference builds them, and
    the angles float32 positions times them."""
    hd = x.shape[-1]
    half = hd // 2
    ang = positions[..., None].float() * _rope_freq(half, theta, x.device)
    # ang: (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _rope_freq(half: int, theta: float, device: torch.device):
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.from_numpy(np.asarray(freq, np.float32)).to(device)


def sinusoidal_embed(length: int, d: int) -> np.ndarray:
    """Whisper-style sinusoidal position table (length, d)."""
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1))
    ang = np.arange(length)[:, None] * freq[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# activations


def activate(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


# ---------------------------------------------------------------------------
# losses


def cross_entropy(logits, labels, mask=None, z_loss: float = 0.0, *,
                  tp=None, vocab: int | None = None):
    """Mean token NLL with optional validity mask; fp32 throughout. With
    ``tp`` (a `ModelGroup`), ``logits`` is this rank's block of a
    ``vocab``-wide vocabulary, and the log-sum-exp and gold logit are the
    vocabulary-parallel ones (`tensor_parallel.lse_and_gold`); over one
    rank the same ops as without."""
    logits = constrain(logits.float(), ("batch", None, "act_vocab"))
    lse, gold = lse_and_gold(tp, logits, labels.long(),
                             vocab or logits.shape[-1])
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse**2
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
