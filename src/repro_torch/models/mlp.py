"""Dense MLP blocks: gated (SwiGLU/GeGLU) and the RWKV channel mix."""

from __future__ import annotations

import torch

from repro_torch.models.common import activate
from repro_torch.sharding.rules import ParamSpec


def mlp_specs(cfg, stacked: tuple[int, ...] = ()) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    pre = tuple("layers" for _ in stacked)
    return {
        "wi": ParamSpec(stacked + (d, ff), pre + ("d_model", "d_ff")),
        "wg": ParamSpec(stacked + (d, ff), pre + ("d_model", "d_ff")),
        "wo": ParamSpec(stacked + (ff, d), pre + ("d_ff", "d_model")),
    }


def mlp(cfg, p, x, tp=None):
    """Gated MLP: act(x @ wg) * (x @ wi) @ wo. With ``tp`` (a `ModelGroup`)
    and ``p`` holding this rank's block of ``d_ff``: ``wi`` and ``wg``
    column-parallel, ``wo`` row-parallel, between ``tp.enter`` and
    ``tp.exit``."""
    split = tp is not None and p["wi"].shape[-1] < cfg.d_ff
    if split:
        x = tp.enter(x)
    dt = x.dtype
    g = activate(cfg.act, torch.matmul(x, p["wg"].to(dt)))
    h = torch.matmul(x, p["wi"].to(dt))
    y = torch.matmul(g * h, p["wo"].to(dt))
    return tp.exit(y) if split else y


# ---------------------------------------------------------------------------
# RWKV channel mix (Finch): token-shift lerp + squared-relu FFN


def rwkv_cmix_specs(cfg, stacked: tuple[int, ...] = ()) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    pre = tuple("layers" for _ in stacked)
    return {
        "mu_k": ParamSpec(stacked + (d,), pre + ("d_model",), init="ones", scale=0.5),
        "mu_r": ParamSpec(stacked + (d,), pre + ("d_model",), init="ones", scale=0.5),
        "wk": ParamSpec(stacked + (d, ff), pre + ("d_model", "d_ff")),
        "wv": ParamSpec(stacked + (ff, d), pre + ("d_ff", "d_model")),
        "wr": ParamSpec(stacked + (d, d), pre + ("d_model", "d_model")),
    }


def _token_shift(x, x_last=None):
    """x_{t-1} along seq; first position sees x_last (decode carry) or 0."""
    prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    if x_last is not None:
        prev[:, 0] = x_last
    return prev


def rwkv_cmix(cfg, p, x, x_last=None, tp=None):
    """Returns (y, new_x_last) — new_x_last is the carry for decode. With
    ``tp`` (a `ModelGroup`) and ``p`` holding this rank's block of
    ``d_ff``: the key's lerp enters the split region, ``wk`` is
    column-parallel and ``wv`` row-parallel, and ``tp.exit`` sums the
    value before the receptance gates it; ``mu_k``, ``mu_r`` and ``wr``
    are read whole outside the region."""
    dt = x.dtype
    prev = _token_shift(x, x_last)
    mu_k = p["mu_k"].to(dt)
    mu_r = p["mu_r"].to(dt)
    xk = x * mu_k + prev * (1 - mu_k)
    xr = x * mu_r + prev * (1 - mu_r)
    split = tp is not None and p["wk"].shape[-1] < cfg.d_ff
    if split:
        xk = tp.enter(xk)
    k = torch.square(torch.relu(torch.matmul(xk, p["wk"].to(dt))))
    kv = torch.matmul(k, p["wv"].to(dt))
    if split:
        kv = tp.exit(kv)
    r = torch.sigmoid(torch.matmul(xr, p["wr"].to(dt)))
    return r * kv, x[:, -1]
