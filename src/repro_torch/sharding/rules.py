"""Parameter declarations: shape, logical axes and initializer.

Every parameter of the LM stack is declared once as a `ParamSpec`. This
module holds the one-device part of the JAX package's
``repro/sharding/rules.py``: `ParamSpec`, `init_params` (real tensors from
an explicit ``torch.Generator``), `abstract_params` (tensors on the
``meta`` device, no allocation) and `constrain`, which is the identity on
one device as the reference's is without a mesh. The logical axis names
are kept for the mesh; `ShardingRules`, `resolve_pspec` and the mesh
functions come with the training slice (ROADMAP.md Queue 1 item 12c).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    """Shape + logical axis names + initializer for one parameter."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | scaled
    scale: float = 1.0
    dtype: str = "float32"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_specs(fn, specs):
    """``fn(path, spec)`` over a nested dict of `ParamSpec`, in sorted key
    order (the order of ``jax.tree.flatten``); returns the same nesting."""
    def walk(node, path):
        if isinstance(node, ParamSpec):
            return fn(path, node)
        return {k: walk(node[k], path + (k,)) for k in sorted(node)}
    return walk(specs, ())


def constrain(x, axes: tuple[str | None, ...]):
    """Sharding constraint by logical axes: the identity on one device."""
    del axes
    return x


def abstract_params(specs, dtype=None):
    """The tree of `specs` as tensors on the ``meta`` device."""
    return tree_map_specs(
        lambda _, ps: torch.empty(ps.shape, device="meta",
                                  dtype=getattr(torch, dtype or ps.dtype)),
        specs)


def _init_one(ps: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, ps.dtype)
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=device)
    # the reference's fan-in: the second-to-last dim (for wq (d, h, hd)
    # that is h), which sets the logits' scale
    fan_in = ps.shape[-2] if len(ps.shape) >= 2 else ps.shape[-1]
    std = ps.scale / np.sqrt(max(fan_in, 1))
    x = torch.empty(ps.shape, dtype=torch.float32, device=device)
    x.normal_(generator=generator)
    return (x * std).to(dtype)


def init_params(specs, generator: torch.Generator, device):
    """Real parameters drawn from ``generator`` (which lives on ``device``),
    one leaf after another in sorted key order."""
    device = torch.device(device)
    return tree_map_specs(lambda _, ps: _init_one(ps, generator, device),
                          specs)
