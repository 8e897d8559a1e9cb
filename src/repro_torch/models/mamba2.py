"""Mamba2 (SSD) block, used standalone and inside the Zamba2 hybrid; the
JAX package's block in torch ops.

State-space duality form: per head, scalar decay a_t = exp(-softplus(dt_t +
dt_bias) * exp(A_log)), shared (ngroups=1) B_t/C_t of size ssm_state, value
path v_t = dt_t * x_t — linear attention with q=C, k=B and a scalar
per-head data-dependent decay, which reuses chunked_gla directly (decay
vector broadcast over ssm_state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _pad_seq
from repro_torch.models.common import rms_norm
from repro_torch.models.linear_attn import chunked_gla, step_gla
from repro_torch.sharding.rules import ParamSpec


def mamba2_specs(cfg, stacked: tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds = cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    cw = cfg.ssm_conv
    pre = tuple("layers" for _ in stacked)

    def mat(shape, axes, **kw):
        return ParamSpec(stacked + shape, pre + axes, **kw)

    return {
        "wz": mat((d, di), ("d_model", "d_ff")),
        "wx": mat((d, di), ("d_model", "d_ff")),
        "wB": mat((d, ds), ("d_model", "ssm_state")),
        "wC": mat((d, ds), ("d_model", "ssm_state")),
        "wdt": mat((d, nh), ("d_model", "ssm_heads")),
        "dt_bias": mat((nh,), ("ssm_heads",), init="zeros"),
        "A_log": mat((nh,), ("ssm_heads",), init="zeros"),
        "D": mat((nh,), ("ssm_heads",), init="ones"),
        "conv_w": mat((cw, di), ("conv_width", "d_ff")),
        "conv_b": mat((di,), ("d_ff",), init="zeros"),
        "norm_scale": mat((di,), ("d_ff",), init="ones"),
        "wo": mat((di, d), ("d_ff", "d_model")),
    }


def _causal_conv(x, w, b, carry=None):
    """Depthwise causal conv over seq. x (B,S,di); w (cw,di).

    carry: (B, cw-1, di) previous inputs for decode; returns (y, new_carry).
    """
    cw = w.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(cw))
    return y + b.to(x.dtype), xp[:, -(cw - 1):]


def _proj(cfg, p, x):
    dt_ = x.dtype
    z = torch.matmul(x, p["wz"].to(dt_))
    xs = torch.matmul(x, p["wx"].to(dt_))
    bmat = torch.matmul(x, p["wB"].to(dt_))
    cmat = torch.matmul(x, p["wC"].to(dt_))
    dt_raw = torch.matmul(x, p["wdt"].to(dt_))
    return z, xs, bmat, cmat, dt_raw


def _softplus(x):
    """log(1 + e^x) as jax.nn.softplus writes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_inputs(cfg, p, xs_conv, bmat, cmat, dt_raw):
    """Assemble (q, k, v, log_decay) for chunked_gla."""
    b, s, di = xs_conv.shape
    nh = di // cfg.ssm_head_dim
    ds = cfg.ssm_state
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())   # (B,S,H)
    a = torch.exp(p["A_log"].float())                      # (H,)
    log_decay = -dt * a                                    # (B,S,H)
    log_decay = log_decay[..., None].expand(b, s, nh, ds)
    k = F.silu(bmat)[:, :, None, :].expand(b, s, nh, ds)
    q = F.silu(cmat)[:, :, None, :].expand(b, s, nh, ds)
    v = (xs_conv.reshape(b, s, nh, cfg.ssm_head_dim)
         * dt[..., None].to(xs_conv.dtype))
    return q, k, v, log_decay, dt


def _rms_norm_over_model(tp, x, scale, eps, width: int):
    """`rms_norm` over a last dim of ``width`` of which ``x`` holds this
    rank's block (and ``scale`` its block of the scale): each rank's sum of
    squares, summed over "model" forward and, since every rank's block
    reads the total, its gradient summed backward too."""
    dt = x.dtype
    x = x.float()
    total = tp.enter(tp.exit(torch.sum(x * x, dim=-1, keepdim=True)))
    y = x * torch.rsqrt(total / width + eps)
    return (y * scale.float()).to(dt)


def mamba2_block(cfg, p, x, carry=None, tp=None):
    """x (B,S,d) -> (y, new_carry). carry = (conv (B,cw-1,di), state).

    S is padded to a multiple of 16 for the chunked scan and cut back.

    With ``tp`` (a `ModelGroup`) and ``p`` holding this rank's block of
    ``d_ff`` (d_inner) and of ``ssm_heads``, whose contiguous blocks line
    up head for head: ``x`` enters the split region, ``wz``, ``wx`` and
    ``wdt`` are column-parallel, the conv, the decay, ``D`` and the scan
    are each channel's or head's own, ``wB`` and ``wC`` are read whole
    inside the region ("partial"), the gated norm's mean of squares runs
    over every rank's block (`_rms_norm_over_model`), and ``wo`` is
    row-parallel before ``tp.exit``."""
    b, s, d = x.shape
    width = cfg.ssm_expand * d
    split = tp is not None and p["wz"].shape[-1] < width
    if split:
        x = tp.enter(x)
    di = p["wz"].shape[-1]
    nh = di // cfg.ssm_head_dim
    conv_carry, state = carry if carry is not None else (None, None)

    z, xs, bmat, cmat, dt_raw = _proj(cfg, p, x)
    xs, conv_carry = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_carry)
    xs = F.silu(xs)
    q, k, v, log_decay, _ = _ssm_inputs(cfg, p, xs, bmat, cmat, dt_raw)

    pad = (-s) % 16
    if pad:
        q, k, v, log_decay = (_pad_seq(a, pad) for a in (q, k, v, log_decay))
    o, state = chunked_gla(q, k, v, log_decay, u=None, initial_state=state)
    o = o[:, :s]

    o = o + (p["D"].to(o.dtype)[None, None, :, None]
             * xs.reshape(b, s, nh, cfg.ssm_head_dim))
    o = o.reshape(b, s, di)
    if split:
        o = _rms_norm_over_model(tp, o * F.silu(z), p["norm_scale"],
                                 cfg.norm_eps, width)
        y = tp.exit(torch.matmul(o, p["wo"].to(x.dtype)))
    else:
        o = rms_norm(o * F.silu(z), p["norm_scale"], cfg.norm_eps)
        y = torch.matmul(o, p["wo"].to(x.dtype))
    return y, (conv_carry, state)


def mamba2_step(cfg, p, x, carry, tp=None):
    """Single-token decode. x (B,1,d). With ``tp`` and ``p`` holding this
    rank's block of d_inner and of its heads, as `mamba2_block`'s split
    path: the conv carry is the rank's d_inner block and the state its
    heads', the gated norm's mean of squares is summed over "model" (one
    all_reduce: no gradient flows), and ``wo`` is row-parallel before
    ``tp.exit``."""
    b, _, d = x.shape
    width = cfg.ssm_expand * d
    split = tp is not None and p["wz"].shape[-1] < width
    if split:
        x = tp.enter(x)
    di = p["wz"].shape[-1]
    nh = di // cfg.ssm_head_dim
    conv_carry, state = carry
    z, xs, bmat, cmat, dt_raw = _proj(cfg, p, x)
    xs, conv_carry = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_carry)
    xs = F.silu(xs)
    q, k, v, log_decay, _ = _ssm_inputs(cfg, p, xs, bmat, cmat, dt_raw)
    o, state = step_gla(q, k, v, log_decay, None, state)
    o = o + (p["D"].to(o.dtype)[None, None, :, None]
             * xs.reshape(b, 1, nh, cfg.ssm_head_dim))
    o = o.reshape(b, 1, di)
    if split:
        o = _rms_norm_over_model(tp, o * F.silu(z), p["norm_scale"],
                                 cfg.norm_eps, width)
        y = tp.exit(torch.matmul(o, p["wo"].to(x.dtype)))
    else:
        o = rms_norm(o * F.silu(z), p["norm_scale"], cfg.norm_eps)
        y = torch.matmul(o, p["wo"].to(x.dtype))
    return y, (conv_carry, state)


def mamba2_state_init(cfg, batch: int, dtype=torch.float32, device=None):
    """(conv carry (B, cw-1, di) in ``dtype``, state (B, H, ds, hd) in
    float32)."""
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    return (torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                        device=device),
            torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_head_dim),
                        dtype=torch.float32, device=device))
