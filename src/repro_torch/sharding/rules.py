"""Parameter declarations and logical-axis sharding rules (MaxText-style).

Every parameter of the LM stack is declared once as a `ParamSpec` with
*logical* dimension names; a `ShardingRules` table maps logical names to
mesh axes. This module holds the one-device part of the JAX package's
``repro/sharding/rules.py``: `ParamSpec`, `ShardingRules`, `resolve_pspec`
and `spec_for` (pure logic over a mesh's ``.shape``; a partition spec is
a tuple here, one entry a dim: a mesh axis, a tuple of them, or None),
`use_rules`, `init_params` (real tensors from an explicit
``torch.Generator``), `abstract_params` (tensors on the ``meta`` device,
no allocation) and `constrain`, which is the identity on one device as
the reference's is without a mesh. The functions that place tensors on a
mesh (`param_shardings`, `tree_shardings`, a ``DeviceMesh`` for the
train state) come with training on a mesh (ROADMAP.md Queue 1 item 12d).
"""

from __future__ import annotations

from dataclasses import dataclass, field

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


MeshAxes = str | tuple[str, ...] | None


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple, or None=replicated)."""
    rules: dict[str, MeshAxes] = field(default_factory=dict)

    @classmethod
    def default(cls, multi_pod: bool = False) -> "ShardingRules":
        batch: MeshAxes = ("pod", "data") if multi_pod else ("data",)
        return cls(rules={
            # --- activations ---
            "batch": batch,
            "seq": None,            # sequence parallelism off by default
            "act_heads": "model",
            "act_d_ff": "model",
            "act_vocab": "model",
            "cache_batch": batch,
            "cache_seq": None,      # decode caches: seq replicated by default
            "cache_heads": "model",
            "cache_head_dim": "model",  # fallback when kv_heads % model != 0
            # --- params ---
            "d_model": "data",      # FSDP axis
            "heads": "model",
            "kv_heads": "model",
            "head_dim": None,
            "d_ff": "model",
            "vocab": "model",
            "experts": None,        # TP-MoE: experts replicated, d_ff split
            "layers": None,
            "ssm_state": None,
            "ssm_heads": "model",
            "conv_width": None,
            "frames": None,
        })

    def with_overrides(self, **kv: MeshAxes) -> "ShardingRules":
        new = dict(self.rules)
        new.update(kv)
        return ShardingRules(rules=new)

    def mesh_axes(self, logical: str | None) -> MeshAxes:
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(f"no sharding rule for logical axis {logical!r}")
        return self.rules[logical]

    def pspec(self, axes: tuple[str | None, ...], mesh,
              shape: tuple[int, ...] | None = None) -> tuple:
        return resolve_pspec(shape or tuple(None for _ in axes), axes,
                             self, mesh)


def resolve_pspec(shape, axes, rules: ShardingRules, mesh) -> tuple:
    """Greedy dim->mesh-axis assignment with divisibility + no-reuse.

    For each dim (in order), take the rule's mesh axes left-to-right and
    keep every axis that (a) exists in this mesh, (b) is not already used
    by an earlier dim, and (c) keeps the dim evenly divisible. This makes
    fallback chains expressible in the rules themselves: decode caches
    list both ``cache_heads -> model`` and ``cache_head_dim -> model``,
    and whichever dim divides first claims the axis. ``mesh`` is anything
    with a ``.shape`` mapping axis names to sizes.
    """
    out, used = [], set()
    for dim, a in zip(shape, axes):
        m = rules.mesh_axes(a)
        if m is None:
            out.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        chosen, prod = [], 1
        for x in ms:
            if x not in mesh.shape or x in used:
                continue
            if dim is not None and dim % (prod * mesh.shape[x]) != 0:
                continue
            chosen.append(x)
            prod *= mesh.shape[x]
        used.update(chosen)
        out.append(tuple(chosen) if len(chosen) > 1
                   else (chosen[0] if chosen else None))
    return tuple(out)


def spec_for(ps: ParamSpec, rules: ShardingRules, mesh) -> tuple:
    return resolve_pspec(ps.shape, ps.axes, rules, mesh)


_ACTIVE_RULES: list[ShardingRules] = []


class use_rules:
    """Context manager installing the rules used by ``constrain``."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()


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
