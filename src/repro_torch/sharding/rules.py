"""Parameter declarations and logical-axis sharding rules (MaxText-style).

Every parameter of the LM stack is declared once as a `ParamSpec` with
*logical* dimension names; a `ShardingRules` table maps logical names to
mesh axes. This module is the JAX package's ``repro/sharding/rules.py``:
`ParamSpec`, `ShardingRules`, `resolve_pspec` and `spec_for` (pure logic
over a mesh's axis sizes; a partition spec is a tuple here, one entry a
dim: a mesh axis, a tuple of them, or None), `use_rules`, `init_params`
(real tensors from an explicit ``torch.Generator``) and `abstract_params`
(tensors on the ``meta`` device, no allocation).

The mesh half: a mesh is a ``torch.distributed`` ``DeviceMesh`` with
named dims ("data", "model"[, "pod"]), the counterpart of
``jax.sharding.Mesh``, or for the pure functions anything with named
axis sizes. `NamedSharding` holds a mesh and a resolved spec and maps
it onto DTensor placements; `param_shardings` and `tree_shardings` give
one a leaf; `place` turns a tree into DTensors on them, each rank
cutting its own block (`local_slices`); `model_dim` and `model_slices`
give the "model" dim and a leaf's block along it, which the model holds
where the rules split a dim there (`TransformerLM.split_over_model`);
`constrain` redistributes a DTensor inside `use_mesh` (the counterpart
of ``with mesh:``) and is the identity without one.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.tree import (flatten_up_to, tree_flatten, tree_map,
                              tree_unflatten)


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
    and whichever dim divides first claims the axis. ``mesh`` is a
    ``DeviceMesh`` or anything with a ``.shape`` mapping axis names to
    sizes.
    """
    sizes = mesh_shape(mesh)
    out, used = [], set()
    for dim, a in zip(shape, axes):
        m = rules.mesh_axes(a)
        if m is None:
            out.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        chosen, prod = [], 1
        for x in ms:
            if x not in sizes or x in used:
                continue
            if dim is not None and dim % (prod * sizes[x]) != 0:
                continue
            chosen.append(x)
            prod *= sizes[x]
        used.update(chosen)
        out.append(tuple(chosen) if len(chosen) > 1
                   else (chosen[0] if chosen else None))
    return tuple(out)


def spec_for(ps: ParamSpec, rules: ShardingRules, mesh) -> tuple:
    return resolve_pspec(ps.shape, ps.axes, rules, mesh)


# ---------------------------------------------------------------------------
# the mesh half


def mesh_dim_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names in its dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s ``.shape`` is a tuple in dim
    order, a duck-typed mesh's a mapping already."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh_dim_names(mesh), mesh.shape))


@dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding(mesh, P(*spec))``: ``spec`` is the tuple
    `resolve_pspec` returns, one entry a tensor dim."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        """The DTensor placements, one a mesh dim: ``Shard(i)`` where the
        dim's name is in ``spec[i]``, else ``Replicate()``. A tuple entry
        such as ("pod", "data") shards one tensor dim over several mesh
        dims; DTensor nests those in mesh-dim order (the first named is
        the outermost split), as JAX does in the tuple's order, so a
        tuple in another order than the mesh's raises."""
        from torch.distributed.tensor import Replicate, Shard
        names = mesh_dim_names(self.mesh)
        owner = {}
        for i, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {entry!r} of dim {i} is not in the mesh's "
                    f"dim order {names}: DTensor nests a dim's shards in "
                    f"mesh-dim order")
            owner.update((a, i) for a in axes)
        return tuple(Shard(owner[n]) if n in owner else Replicate()
                     for n in names)


def param_shardings(specs, rules: ShardingRules, mesh):
    """A `NamedSharding` a `ParamSpec` of ``specs``, the same nesting."""
    return tree_map_specs(
        lambda _, ps: NamedSharding(mesh, spec_for(ps, rules, mesh)), specs)


def tree_shardings(shape_tree, axes_tree, rules: ShardingRules, mesh):
    """Shardings for a tree of tensors (or anything with ``.shape``) given a
    parallel tree of logical-axis tuples (used for decode caches)."""
    leaves, tdef = tree_flatten(shape_tree)
    axes = flatten_up_to(tdef, axes_tree)
    return tree_unflatten(tdef, [
        NamedSharding(mesh, resolve_pspec(tuple(x.shape), ax, rules, mesh))
        for x, ax in zip(leaves, axes)])


def local_slices(shape, mesh, placements) -> tuple:
    """This rank's block of a global tensor of ``shape`` under
    ``placements``: a dim sharded over several mesh dims is split by the
    first of them (in mesh order) outermost. Every split must be even, as
    the rules' divisibility makes it."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    index, parts = [0] * len(shape), [1] * len(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            index[pl.dim] = index[pl.dim] * n + coord[i]
            parts[pl.dim] *= n
    out = []
    for size, f, n in zip(shape, index, parts):
        if size % n:
            raise ValueError(f"a dim of {size} does not split into {n} "
                             f"equal shards (shape {tuple(shape)})")
        out.append(slice(f * (size // n), (f + 1) * (size // n)))
    return tuple(out)


def model_dim(mesh) -> tuple[int, int, object]:
    """(size, this rank's coordinate, process group) of ``mesh``'s "model"
    dim: (1, 0, None) where the mesh has none. A `ShapeMesh` has no
    process groups (None), and its coordinate is 0 unless it is a rank's
    view (``ShapeMesh.at``)."""
    names = mesh_dim_names(mesh)
    if "model" not in names:
        return 1, 0, None
    i = names.index("model")
    coord = mesh.get_coordinate()
    return (mesh_shape(mesh)["model"], coord[i] if coord else 0,
            mesh.get_group("model"))


def model_slices(shape, dim: int | None, mesh) -> tuple:
    """This rank's block of a global tensor of ``shape`` along "model"
    alone: `local_slices` restricted to that mesh dim, which splits tensor
    dim ``dim`` (None: the whole tensor)."""
    size, rank, _ = model_dim(mesh)
    out = [slice(None)] * len(shape)
    if dim is not None:
        n = shape[dim]
        if n % size:
            raise ValueError(f"a dim of {n} does not split into {size} "
                             f"equal shards (shape {tuple(shape)})")
        out[dim] = slice(rank * (n // size), (rank + 1) * (n // size))
    return tuple(out)


def from_block(local: torch.Tensor, shape, sh: NamedSharding):
    """The DTensor of global ``shape`` whose block on this rank is
    ``local`` (`local_slices`' block, contiguous)."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def shard_like(x: torch.Tensor, sh: NamedSharding):
    """A DTensor of the global tensor ``x`` (the same on every rank) with
    ``sh``'s placements, cut locally: no collective. The local block is a
    copy, never a view of ``x``."""
    local = x.detach()[local_slices(x.shape, sh.mesh, sh.placements)].clone(
        memory_format=torch.contiguous_format)
    return from_block(local, x.shape, sh)


def place(tree, shardings):
    """Every leaf of ``tree`` as a DTensor with the placements of its
    sharding in ``shardings`` (the same nesting): a plain tensor is cut
    locally (`shard_like`), a DTensor redistributed if it differs."""
    from torch.distributed.tensor import DTensor

    def one(x, sh):
        if not isinstance(x, DTensor):
            return shard_like(x, sh)
        if tuple(x.placements) != sh.placements:
            return x.redistribute(sh.mesh, sh.placements)
        return x
    return tree_map(one, tree, shardings)


_ACTIVE_RULES: list[ShardingRules] = []
_ACTIVE_MESH: list = []


class use_rules:
    """Context manager installing the rules used by ``constrain``."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()


class use_mesh:
    """Context manager installing the mesh `constrain` reads (the
    reference's ``with mesh:``)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()


def tree_map_specs(fn, specs):
    """``fn(path, spec)`` over a nested dict of `ParamSpec`, in sorted key
    order (the order of ``jax.tree.flatten``); returns the same nesting."""
    return _map_specs(fn, specs, ())


def _map_specs(fn, node, path):
    # recursive at module level: a nested recursive function is a
    # reference cycle, which would keep ``fn`` and what it holds (a
    # caller's parameters) alive until the next garbage collection
    if isinstance(node, ParamSpec):
        return fn(path, node)
    return {k: _map_specs(fn, node[k], path + (k,)) for k in sorted(node)}


def constrain(x, axes: tuple[str | None, ...]):
    """Sharding constraint by logical axes; the identity without a mesh.

    Inside `use_mesh`, a DTensor ``x`` is redistributed to the placements
    its shape resolves to under the active rules (the default rules of
    the mesh when none are installed). A plain tensor stays as it is: it
    is one rank's value, whole or its block over "model", whose layout
    the model's tensor-parallel regions already fix
    (`repro_torch.sharding.tensor_parallel`); the reference's constraint
    steers GSPMD's partitioning of the same function.
    """
    from torch.distributed.tensor import DTensor
    if not _ACTIVE_MESH or not isinstance(x, DTensor):
        return x
    mesh = _ACTIVE_MESH[-1]
    rules = _ACTIVE_RULES[-1] if _ACTIVE_RULES else ShardingRules.default(
        multi_pod="pod" in mesh_dim_names(mesh))
    sh = NamedSharding(mesh, resolve_pspec(tuple(x.shape), axes, rules, mesh))
    return x.redistribute(mesh, sh.placements)


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
