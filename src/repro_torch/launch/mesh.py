"""Mesh construction: a ``torch.distributed`` ``DeviceMesh`` with named
dims, the counterpart of the JAX package's ``repro/launch/mesh.py``.

Functions, not module-level constants: building a mesh needs a process
group of the right world size, which importing this module must not
require.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


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
