"""Dense gated MLP (SwiGLU/GeGLU). The RWKV channel mix comes with the
``R`` layers (ROADMAP.md Queue 1 item 12b)."""

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


def mlp(cfg, p, x):
    """Gated MLP: act(x @ wg) * (x @ wi) @ wo."""
    dt = x.dtype
    g = activate(cfg.act, torch.matmul(x, p["wg"].to(dt)))
    h = torch.matmul(x, p["wi"].to(dt))
    return torch.matmul(g * h, p["wo"].to(dt))
