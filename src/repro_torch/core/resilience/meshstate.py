"""Logical device-health registry: graceful mesh degradation.

The distributed engines assume every rank of the mesh answers its
collectives; on a real fleet, chips get cordoned and hosts drop mid-job.
A process cannot kill a peer rank to test that, so this module keeps the
fiction the rest of the resilience layer agrees on: a set of lost devices
plus an epoch counter. A device is a global rank of the default process
group, the entries of a `DeviceMesh`'s ``mesh`` tensor. Simulated loss
(`lose_devices`, or `FaultInjector.apply_device_loss` for scheduled chaos)
bumps the epoch; `repro_torch.fft.plan(..., fallback="degrade")` checks
`mesh_healthy` before committing to a mesh placement and re-plans on a
shrunk mesh (`shrunk_mesh`) or mesh-free when ranks are gone, instead of
launching collectives that would hang.

The registry is process-local. In an SPMD program every rank must mark
the same losses, in the same order, because a shrunk mesh's process
groups are created collectively: every rank of the default group builds
them, the lost and the left-out ones included. A caller that must plan on
the same losses it has told the other ranks about holds the registry
still meanwhile (`held`).
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.core.resilience.events import record_event

_LOCK = threading.Lock()
# held by `held()`: losses and restores from other threads wait for it
_HOLD = threading.RLock()
_LOST: set = set()   # global ranks considered dead
_EPOCH = 0           # bumps on every loss/restore (cache-invalidation tag)
# shrunk meshes built so far, by (device type, ranks, dim name): building
# one creates process groups, so each is built once per process
_SHRUNK: dict = {}


def lose_devices(device_ids) -> None:
    """Mark global ranks lost (simulated datanode/chip failure)."""
    global _EPOCH
    ids = {int(d) for d in device_ids}
    if not ids:
        return
    with _HOLD, _LOCK:
        _LOST.update(ids)
        _EPOCH += 1
        epoch = _EPOCH
    record_event("device_loss", device_ids=sorted(ids), epoch=epoch)


def restore_devices(device_ids=None) -> None:
    """Heal global ranks (None = all): test/benchmark teardown."""
    global _EPOCH
    with _HOLD, _LOCK:
        if device_ids is None:
            healed = sorted(_LOST)
            _LOST.clear()
        else:
            healed = sorted(_LOST & {int(d) for d in device_ids})
            _LOST.difference_update(healed)
        if not healed:
            return
        _EPOCH += 1
        epoch = _EPOCH
    record_event("device_restore", device_ids=healed, epoch=epoch)


@contextlib.contextmanager
def held():
    """Keep the registry as it is while the block runs: `lose_devices` and
    `restore_devices` from other threads wait until it ends. The holding
    thread may still change it."""
    with _HOLD:
        yield


def lost_devices() -> frozenset:
    with _LOCK:
        return frozenset(_LOST)


def epoch() -> int:
    """Monotonic health-change counter (plan-cache invalidation tag)."""
    with _LOCK:
        return _EPOCH


def healthy_devices(mesh) -> list:
    """The mesh's global ranks that are not marked lost, in mesh order."""
    lost = lost_devices()
    return [r for r in mesh.mesh.reshape(-1).tolist() if r not in lost]


def mesh_healthy(mesh) -> bool:
    """True when every rank of ``mesh`` still answers."""
    return len(healthy_devices(mesh)) == mesh.mesh.numel()


def shrunk_mesh(mesh):
    """The largest power-of-two 1-D mesh of still-healthy ranks, or None.

    Degraded re-planning target: the distributed engines need a pow2 rank
    count, and a 1-D mesh named after the mesh's first dim is the most
    general shape every placement accepts. It holds the first k healthy
    ranks in mesh order. None when fewer than 2 healthy ranks remain
    (degrade goes mesh-free/local instead). Collective the first time a
    given shrunk mesh is built (module docstring).
    """
    healthy = healthy_devices(mesh)
    k = 1
    while k * 2 <= len(healthy):
        k *= 2
    if k < 2:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    key = (mesh.device_type, tuple(healthy[:k]), mesh.mesh_dim_names[0])
    with _LOCK:
        sub = _SHRUNK.get(key)
    if sub is None:
        sub = DeviceMesh(mesh.device_type, list(key[1]),
                         mesh_dim_names=(key[2],))
        with _LOCK:
            sub = _SHRUNK.setdefault(key, sub)
    return sub
