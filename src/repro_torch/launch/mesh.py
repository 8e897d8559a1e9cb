"""Mesh construction: a ``torch.distributed`` ``DeviceMesh`` with named
dims, the counterpart of the JAX package's ``repro/launch/mesh.py``, and
`ShapeMesh`, a mesh of shape only, which the dryruns plan on.

Functions, not module-level constants: building a mesh needs a process
group of the right world size, which importing this module must not
require.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# the JAX package's production meshes, and one card
MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "one_card": ((1, 1), ("data", "model"))}


class ShapeMesh:
    """A device mesh's shape and dim names, without devices or process
    groups: what the FFT planner's cost model (`mesh_dim_names`, `size`)
    and the sharding rules (`shape`, and `get_coordinate` for
    `local_slices`; `model_dim` for the "model" dim a model splits over)
    read, planned as "cpu" so no card is touched. Its coordinate is None
    (no rank's view) unless made by `at`."""

    device_type = "cpu"

    def __init__(self, shape, names, coordinate=None):
        self.mesh = torch.arange(math.prod(shape)).reshape(shape)
        self.mesh_dim_names = tuple(names)
        self.coordinate = coordinate

    @property
    def ndim(self) -> int:
        return self.mesh.dim()

    @property
    def shape(self) -> tuple:
        return tuple(self.mesh.shape)

    def size(self, dim: int | None = None) -> int:
        return self.mesh.numel() if dim is None else self.mesh.shape[dim]

    def get_coordinate(self):
        return self.coordinate

    def get_group(self, mesh_dim=None):
        """None: a mesh of shape only has no process groups (the
        tensor-parallel operators over it move nothing and count the bytes
        they would)."""
        return None

    def at(self, rank: int) -> "ShapeMesh":
        """The same mesh as seen by global ``rank``."""
        coord = [int(c) for c in (self.mesh == rank).nonzero()[0]]
        return ShapeMesh(self.shape, self.mesh_dim_names, coord)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16x16 = 256 ranks single pod; (2,16,16) = 512 ranks across 2 pods.
    Like the reference's, it needs a process group of that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device_type="cuda"):
    """Over the current process group's world: a 1-D data mesh, or a
    (data, model) mesh when ``model_axis`` > 1 divides the world. The
    ranks' devices are cards unless the caller asks for "cpu"."""
    n = dist.get_world_size()
    if model_axis > 1 and n % model_axis == 0:
        return init_device_mesh(device_type, (n // model_axis, model_axis),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))
