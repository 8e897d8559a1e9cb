"""Checkpointing: atomic, async, keep-N, in the JAX package's layout.

Layout:  <dir>/step_<n>/leaf_<i>.npy + manifest.json + COMMIT marker,
the leaves numbered in ``jax.tree.flatten``'s order (`repro_torch.tree`).
It is the reference's layout byte for byte in every array, so a train
state saved by either package restores in the other.

  * atomic: leaves land in ``.tmp_step_<n>``; the directory is renamed and
    a COMMIT marker written only after every leaf fsync'd — a crash mid-save
    never yields a checkpoint that ``latest_step`` would pick up;
  * auto-resume: ``latest_step`` returns the newest COMMITted step and
    ignores torn ones;
  * the leaves are whole (global) arrays on the host, from a mesh too;
    ``restore`` puts each one on the device asked for, or with
    ``shardings`` gives each rank its own block of it as a DTensor on the
    current mesh, whatever mesh saved it (elastic: a state saved on
    (2, 2) restores onto (4, 1), (1, 1) or no mesh);
  * async: ``CheckpointManager.save_async`` snapshots to the host (blocking
    on the device->host copy only; on a mesh every rank gathers every
    leaf, and the mesh's first rank alone writes) and writes in a
    background thread; keep_n GC. On a mesh ``wait`` returns on every
    rank once the write is committed, and ``latest`` is the writer's
    answer on every rank.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.rules import from_block, local_slices
from repro_torch.tree import (flatten_up_to, tree_flatten, tree_map,
                              tree_unflatten)

COMMIT = "COMMIT"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _snapshot(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates of the live
    state do not reach (a CPU tensor's ``.numpy()`` shares its memory); a
    DTensor is gathered whole first (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(step: int, tree, ckpt_dir: os.PathLike) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, treedef = tree_flatten(tree)
    manifest = {"step": step, "treedef": str(treedef), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _as_numpy(leaf)
        path = tmp / f"leaf_{i:05d}.npy"
        with open(path, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append(
            {"i": i, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    (final / COMMIT).touch()
    return final


def latest_step(ckpt_dir: os.PathLike) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.glob("step_*"):
        if (p / COMMIT).exists() and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: os.PathLike, step: int, like, device=None,
            shardings=None):
    """Load step ``step`` shaped like ``like`` (a tree of tensors or
    arrays; only their shapes are read); each leaf a tensor on ``device``
    (the host when None). With ``shardings`` (`NamedSharding` s, the
    nesting of ``like``) each leaf is a DTensor with their placements
    whose block on this rank is read from the file alone, on ``device``
    (else the mesh's device: the current card on "cuda"): this is where
    elastic resharding happens."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    leaves, treedef = tree_flatten(like)
    shs = (None,) * len(leaves) if shardings is None else flatten_up_to(
        treedef, shardings)
    out = []
    for i, (leaf, sh) in enumerate(zip(leaves, shs)):
        arr = np.load(d / f"leaf_{i:05d}.npy", mmap_mode="r")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != model {leaf.shape}")
        if sh is None:
            out.append(torch.from_numpy(np.array(arr)).to(device or "cpu"))
            continue
        # a copy: a view would keep the mapped file under the tensor
        block = np.array(arr[local_slices(arr.shape, sh.mesh,
                                          sh.placements)])
        dev = device or _mesh_device(sh.mesh)
        out.append(from_block(torch.from_numpy(block).to(dev), arr.shape, sh))
    return tree_unflatten(treedef, out)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _mesh_sum(mesh, value: int) -> int:
    """``value`` summed over every rank of ``mesh`` (a collective, and a
    barrier: each rank waits for the sum)."""
    from torch.distributed.tensor import DTensor, Partial
    x = torch.tensor([value], dtype=torch.int64, device=_mesh_device(mesh))
    return int(DTensor.from_local(x, mesh, [Partial()] * mesh.ndim)
               .full_tensor()[0])


class CheckpointManager:
    def __init__(self, ckpt_dir: os.PathLike, keep_n: int = 3, mesh=None):
        self.dir = Path(ckpt_dir)
        self.keep_n = keep_n
        self.mesh = mesh
        # the mesh's first rank writes; every rank gathers
        self.writer = mesh is None or int(mesh.mesh.flatten()[0]) == (
            dist.get_rank())
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._lock = threading.Lock()
        # one record a save: step, bytes, snapshot_s (the caller's wait
        # for the device->host copy) and write_s (the background write)
        self.saves: list[dict] = []

    def save_async(self, step: int, tree):
        """Snapshot to host now, write in the background (on a mesh: every
        rank gathers, the writer writes)."""
        t0 = time.monotonic()
        host_tree = tree_map(_snapshot, tree)
        rec = {"step": step, "snapshot_s": time.monotonic() - t0,
               "bytes": sum(a.nbytes for a in tree_flatten(host_tree)[0])}
        if not self.writer:
            self.saves.append(rec)
            return
        with self._lock:
            if self._pending is not None:
                self._pending.result()  # backpressure: one in flight
            self.saves.append(rec)
            self._pending = self._pool.submit(self._write, step, host_tree,
                                              rec)

    def _write(self, step, host_tree, rec):
        t0 = time.monotonic()
        save(step, host_tree, self.dir)
        rec["write_s"] = time.monotonic() - t0
        self._gc()

    def wait(self):
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None
        if self.mesh is not None:
            _mesh_sum(self.mesh, 0)  # every rank past the writer's commit

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if (p / COMMIT).exists())
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def latest(self) -> int | None:
        if self.mesh is None:
            return latest_step(self.dir)
        mine = latest_step(self.dir) if self.writer else None
        s = _mesh_sum(self.mesh, 0 if mine is None else mine + 1) - 1
        return None if s < 0 else s

    def restore_latest(self, like, device=None, shardings=None):
        s = self.latest()
        if s is None:
            return None, None
        return s, restore(self.dir, s, like, device, shardings)
