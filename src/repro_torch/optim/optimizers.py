"""Optimizers, written as the JAX package writes them (no ``torch.optim``).

Every optimizer is a pair of functions over the nested parameter dict:
``init(params) -> state`` and ``update(grads, state, params, lr) ->
(params, state)``, the leaves taken in ``jax.tree.flatten``'s order
(sorted keys). The moments are float32 and the step a 0-d int32 tensor,
and each update is the reference's expression: AdamW adds its weight
decay inside the step (``torch.optim.AdamW`` decays before it, and
rounds differently), adafactor keeps factored row and column statistics
over the last two dims and clips its update by RMS.

``update`` writes the new values into the parameter tensors in place
(under ``torch.no_grad()``), which stands in for the reference's donated
state: the model's own parameters are the ones a step trains. It
returns those same tensors and a new state.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import (flatten_up_to, tree_flatten, tree_leaves,
                              tree_map, tree_unflatten)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before). The squares are summed leaf after leaf in flatten order, as
    the reference's Python ``sum`` adds them."""
    norm = 0
    for g in tree_leaves(grads):
        norm = norm + torch.sum(torch.square(g.float()))
    norm = torch.sqrt(norm)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def _zero_step(params):
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device)


# ---------------------------------------------------------------------------


def sgd(momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "step": _zero_step(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        flat_p, tdef = tree_flatten(params)
        for p, m in zip(flat_p, flatten_up_to(tdef, mu)):
            p.copy_(p - lr * (m + weight_decay * p))
        return params, {"mu": mu, "step": state["step"] + 1}

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"mu": z, "nu": tree_map(torch.clone, z),
                "step": _zero_step(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / c1
            vh = v / c2
            pf = p.float()
            new_p = pf - lr * (mh / (torch.sqrt(vh) + eps)
                               + weight_decay * pf)
            p.copy_(new_p.to(p.dtype))
            return m, v

        flat_p, tdef = tree_flatten(params)
        flat_g = flatten_up_to(tdef, grads)
        flat_m = flatten_up_to(tdef, state["mu"])
        flat_v = flatten_up_to(tdef, state["nu"])
        out = [upd(p, g, m, v) for p, g, m, v
               in zip(flat_p, flat_g, flat_m, flat_v)]
        mu = tree_unflatten(tdef, [o[0] for o in out])
        nu = tree_unflatten(tdef, [o[1] for o in out])
        return params, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018), no momentum.

    >=2D params keep row/col factored statistics over the last two dims;
    <2D params fall back to full second moments.
    """

    def init(params):
        def one(p):
            dev = p.device
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=dev)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"stats": tree_map(one, params), "step": _zero_step(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"] + 1
        beta = 1.0 - (step.float() + 1.0) ** (-decay)

        def one(p, g, s):
            g = g.float()
            g2 = g * g + eps
            if p.ndim >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                u = g * torch.rsqrt(vr[..., None]
                                    / torch.clamp(denom[..., None], min=eps))
                u = u * torch.rsqrt(vc[..., None, :])
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v)
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.float()
            p.copy_((pf - lr * (u + weight_decay * pf)).to(p.dtype))
            return new_s

        flat_p, tdef = tree_flatten(params)
        flat_g = flatten_up_to(tdef, grads)
        flat_s = flatten_up_to(tdef, state["stats"])
        stats = tree_unflatten(tdef, [one(p, g, s) for p, g, s
                                      in zip(flat_p, flat_g, flat_s)])
        return params, {"stats": stats, "step": step}

    return Optimizer(init, update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)
