"""The port's training on a mesh (`Trainer(mesh=DeviceMesh)`, the sharded
train state, the elastic restore, `moe_ep`) against the JAX package's
sharded step on 4 forced host devices.

Both sides run once per test session, in subprocesses of this file,
started together:

* the reference (``python test_torch_mesh_train.py reference <dir>``, with
  XLA_FLAGS=--xla_force_host_platform_device_count=4 set before JAX is
  imported): an Auto-axes (2, 2) ("data", "model") ``jax.sharding.Mesh``
  (``jax.make_mesh``'s Explicit axes make the sharded step raise at the
  embedding gather on this JAX), ``jax.jit(make_train_step(...)[1],
  in_shardings=(state_shardings, batch shardings), out_shardings=...)``
  as ``repro/launch/dryrun.py`` builds it (not imported: importing it
  forces 512 devices), ``moe_ep`` under ``shard_map``, and its
  ``restore(..., shardings=)`` of the port's checkpoint;
* 4 workers of the port (``... worker <rank> <dir>``) in one ``gloo``
  group on `make_host_mesh(model_axis=2)`'s (2, 2) mesh: the
  tensor-parallel step the default rules make, and the replicated step
  of the rules with heads, kv_heads, d_ff and vocab overridden to None;
  then on (4, 1), and qwen3-0.6b, zamba2-7b and whisper-base on (1, 4)
  (their 4 q heads split, their 2 kv heads whole), against the
  reference's step on a (1, 4) mesh;
* one process of the port alone (``... single <dir>``) on a world-size-1
  group: the (1, 1) mesh against the one-device trainer, and the restore
  onto (1, 1) and onto no mesh, of qwen2-0.5b's state and of a split
  zamba2-7b's.

The parameters of both packages are the reference's ``init_params`` with
its biases and norm scales redrawn and, where its init is chaotic, wq and
wk at their true fan-in (`repro_torch.models.conditioning`), carried over
by `models/convert.py`; the MoE configs compute in float64. The batches
(4 x 40 tokens, with a loss mask of a different density a row, and
whisper's 4 x 40 frames) come from a numpy seed. The reference's
process makes these inputs first and the port's processes wait for
them. Under xdist the first worker to take a lock runs all of it and
the others read its results. Every process group has a 60 s timeout
and the subprocesses a bound, so a stuck collective fails the module,
never the whole run. The workers import no JAX.
"""

import datetime
import fcntl
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# (arch, optimizer) of the sharded steps: SGD with int8 compression and
# grad_accum 2 (`trainer_config`), and AdamW at grad_accum 2 (`ACCUM`)
TRAIN = [("qwen2-0.5b", "adamw"), ("gemma3-1b", "adamw"),
         ("mixtral-8x22b", "adafactor"), ("gemma3-1b", "sgd"),
         ("qwen3-0.6b", "adamw"), ("rwkv6-3b", "adamw"),
         ("zamba2-7b", "adamw"), ("whisper-base", "adamw")]
ACCUM = {("qwen3-0.6b", "adamw"): 2}
# the (1, 4) cases: q heads split over "model", kv heads whole
TP14 = ("qwen3-0.6b", "adamw")
FAMILIES14 = [("zamba2-7b", "adamw"), ("whisper-base", "adamw")]
# the cases whose rank-0 step records its FLOPs and its all_reduce bytes
# over "model" (test_torch_lm_dryrun holds the meta cell to them)
COUNTED = [("qwen2-0.5b", "adamw"), ("gemma3-1b", "adamw"),
           ("zamba2-7b", "adamw"), ("whisper-base", "adamw")]
# the (1, 1) mesh against one device, bit for bit: the first three of
# TRAIN and accumulated, compressed SGD
SINGLE = TRAIN[:3] + [("qwen2-0.5b", "sgd")]
MOE = ["mixtral-8x22b", "llama4-scout-17b-a16e"]
STEPS, BATCH, SEQ, LR = 2, 4, 40, 1e-3
MOE_SHAPE = (4, 16)  # (batch, seq) of moe_ep's global input
CKPT_ARCH = "qwen2-0.5b"
SPLIT_CKPT_ARCH = "zamba2-7b"  # a state saved from a model split over "model"
# the reference's launch/dryrun.py BATCH_AXES, with the loss mask (the
# keys a batch has)
BATCH_AXES = {"tokens": ("batch", "seq"), "loss_mask": ("batch", "seq"),
              "frames": ("batch", None, None)}
TOL_METRIC = 1e-5  # |port - ref| / |ref| of each step's loss and grad norm
# ... but zamba2-7b's grad norm after its first AdamW step, held at the
# reference's own spread between its (2, 2) and (1, 4) steps in the same
# run, where that is larger (measured 5.7e-5; see
# test_mesh_steps_match_the_reference): arch -> [(step, metric)]
SPREAD = {"zamba2-7b": [(1, 1)]}
SPREAD_CAP = 1e-4  # the reference's own spread there stays below this
# after step 2, max |port - ref| / max |ref| of a leaf: adafactor's
# parameters, and every optimizer-state leaf at the bound of its config;
# AdamW's parameters within 0.2 lr, or for the configs of ADAMW_LR_BOUND
# all but fewer than ADAMW_FLIP_SHARE of a leaf's entries within 0.2 lr
# and the rest within the config's lr bound (see
# test_mesh_steps_match_the_reference)
TOL_PARAM = 1e-4
STATE_BOUND = {"qwen2-0.5b": 1e-4, "gemma3-1b": 1e-4, "mixtral-8x22b": 1e-3,
               "qwen3-0.6b": 1e-4, "rwkv6-3b": 3e-3, "zamba2-7b": 5e-3,
               "whisper-base": 1e-4}
TOL_ADAMW_LR = 0.2
ADAMW_LR_BOUND = {"rwkv6-3b": 1.0, "zamba2-7b": 2.0}
ADAMW_FLIP_SHARE = 1e-3
TOL_MOE = 1e-5     # max |port - ref| / max |ref|, forward and input grad
# the input gradient entries a bf16 rounding flip reaches (test_moe_ep_...)
MOE_FLIP_SHARE, MOE_FLIP_BOUND = 0.01, 2.0 ** -8
# an entry of compressed SGD's state that moved by more than this share of
# its leaf's quantization levels was flipped (check_flips)
FLIP_FLOOR = 0.1
# the subprocesses' bound: ~110-140 s alone with the rwkv6, zamba2 and
# whisper cases, more beside the other test files' processes
BOUND_S = 420


def trainer_config(optimizer: str, **kw):
    """The keyword arguments of both packages' TrainerConfig."""
    extra = ({"grad_accum": 2, "grad_compression": True}
             if optimizer == "sgd" else {})
    return dict(optimizer=optimizer, base_lr=LR, warmup_steps=0,
                total_steps=10, **extra, **kw)


def train_config(arch: str, optimizer: str, **kw):
    """`trainer_config` of a case of TRAIN (its accumulation)."""
    if (arch, optimizer) in ACCUM:
        kw["grad_accum"] = ACCUM[arch, optimizer]
    return trainer_config(optimizer, **kw)


def tag(arch: str, optimizer: str) -> str:
    """A case's name in the result files."""
    return f"{arch}-{optimizer}"


def case_ids(cases) -> list:
    """An arch's first case is named by the arch, a later one by both."""
    seen, out = set(), []
    for arch, optimizer in cases:
        out.append(f"{arch}-{optimizer}" if arch in seen else arch)
        seen.add(arch)
    return out


def load_params(tmp: Path, arch: str, specs) -> dict:
    """The parameters of ``arch`` in the nesting of ``specs`` (either
    package's ParamSpec tree), empty subtrees too."""
    flat = dict(np.load(tmp / f"params_{arch}.npz"))

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in node.items()}
        return flat[prefix[:-1]]
    return walk(specs, "")


def batches(tmp: Path, arch: str, accum: int = 1) -> list:
    data = np.load(tmp / f"batches_{arch}.npz")
    out = []
    for i in range(STEPS):
        b = {k: data[f"{k}_{i}"] for k in BATCH_AXES if f"{k}_{i}" in data}
        if accum > 1:
            b = {k: v.reshape(accum, BATCH // accum, *v.shape[1:])
                 for k, v in b.items()}
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# the inputs: made by the reference's process from its init, before its
# steps; the port's processes wait for them


def _inputs(tmp: Path) -> None:
    import jax

    from repro.models.moe import moe_specs as ref_moe_specs
    from repro.sharding.rules import init_params as ref_init_params
    from test_torch_lm_serve import case_configs, ref_tree
    from test_torch_train import train_batch

    from repro.models.transformer import TransformerLM as RefLM
    from repro_torch.models.conditioning import GRAD_CONDITIONED
    from repro_torch.models.convert import _flatten

    for arch in sorted({a for a, _ in SINGLE + TRAIN} | set(MOE)):
        cfg, ref_cfg = case_configs(arch)
        tree = ref_tree(RefLM(ref_cfg), 0, arch in GRAD_CONDITIONED)
        np.savez(tmp / f"params_{arch}.npz", **_flatten(tree))
        rng = np.random.default_rng(7)
        out = {}
        for i in range(STEPS):
            out[f"tokens_{i}"] = train_batch(cfg, seed=i, batch=BATCH,
                                             seq=SEQ)["tokens"]
            if cfg.encoder_layers:  # as many frames as tokens, as the
                # dryrun's train shapes have them
                out[f"frames_{i}"] = rng.standard_normal(
                    (BATCH, SEQ, cfg.d_model)).astype(np.float32)
            # row r keeps ~(r + 1) / (BATCH + 1) of its positions
            keep = (np.arange(1, BATCH + 1) / (BATCH + 1))[:, None]
            out[f"loss_mask_{i}"] = (rng.random((BATCH, SEQ)) < keep).astype(
                np.float32)
        np.savez(tmp / f"batches_{arch}.npz", **out)
    for arch in MOE:
        cfg, ref_cfg = case_configs(arch)
        p = jax.tree.map(np.asarray, ref_init_params(
            ref_moe_specs(ref_cfg), jax.random.PRNGKey(3)))
        rng = np.random.default_rng(11)
        x = rng.standard_normal((*MOE_SHAPE, cfg.d_model))
        ct = rng.standard_normal(x.shape)
        np.savez(tmp / f"moe_{arch}.npz", x=x, ct=ct, **p)
    (tmp / "inputs_ready").write_text("ok")


# ---------------------------------------------------------------------------
# the reference: the JAX package on 4 forced host devices


def _reference(tmp: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.checkpoint.manager import restore
    from repro.compat import shard_map
    from repro.configs import get_config
    from repro.models.moe import moe_ep
    from repro.models.transformer import TransformerLM
    from repro.optim.compression import init_error_state
    from repro.sharding.rules import ShardingRules, resolve_pspec
    from repro.train.trainer import (TrainerConfig, make_train_step,
                                     state_shardings)
    from repro_torch.models.conditioning import FLOAT64

    assert len(jax.devices()) == WORLD
    _inputs(tmp)
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = ShardingRules.default()
    rep = NamedSharding(mesh, P())
    res, info = {}, {"specs": {}}

    def ref_config(arch):
        cut = ({"dtype": "float64", "cache_dtype": "float64"}
               if arch in FLOAT64 else {})
        return get_config(arch).reduced(**cut)

    def batch_shardings(mesh, b):
        # microbatches lead, unsharded, ahead of the batch rule's spec
        return {k: NamedSharding(mesh, resolve_pspec(
            v.shape, (None,) * (v.ndim - len(BATCH_AXES[k])) + BATCH_AXES[k],
            rules, mesh)) for k, v in b.items()}

    ckpt_like = None
    for arch, optimizer in TRAIN:
        name = tag(arch, optimizer)
        with jax.enable_x64(arch in FLOAT64):
            model = TransformerLM(ref_config(arch))
            tc = TrainerConfig(**train_config(arch, optimizer))
            opt, step_fn = make_train_step(model, tc)
            params = jax.tree.map(jnp.asarray, load_params(
                tmp, arch, model.param_specs()))
            state = {"params": params, "opt_state": opt.init(params),
                     "step": jnp.zeros((), jnp.int32)}
            if tc.grad_compression:
                state["errors"] = init_error_state(params)
            state_sh = state_shardings(model, state, rules, mesh)
            state = jax.device_put(state, state_sh)
            bs = batches(tmp, arch, tc.grad_accum)
            fn = jax.jit(step_fn, in_shardings=(
                state_sh, batch_shardings(mesh, bs[0])), out_shardings=(
                    state_sh, {"loss": rep, "grad_norm": rep, "lr": rep}))
            metrics = []
            for b in bs:
                state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
                metrics.append([float(m["loss"]), float(m["grad_norm"]),
                                float(m["lr"])])
            res[f"metrics_{name}"] = np.array(metrics)
            for part in ("params", "opt_state", "errors"):
                for i, leaf in enumerate(jax.tree.leaves(state.get(part))):
                    res[f"{part}_{name}_{i}"] = np.asarray(leaf)
            info["specs"][name] = [
                [list(e) if isinstance(e, tuple) else e for e in x.spec]
                for x in jax.tree.leaves(jax.tree.map(
                    lambda a: a.sharding, state))]
            if (arch, optimizer) == (CKPT_ARCH, "adamw"):
                ckpt_like = (jax.tree.map(
                    lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state),
                    state_sh)

    # qwen3-0.6b, zamba2-7b and whisper-base on (1, 4): their 4 q heads
    # split, their 2 kv heads whole
    mesh14 = Mesh(np.asarray(jax.devices()).reshape(1, 4), ("data", "model"))
    rep14 = NamedSharding(mesh14, P())
    for arch, optimizer in [TP14] + FAMILIES14:
        name = tag(arch, optimizer) + "-14"
        model = TransformerLM(ref_config(arch))
        tc = TrainerConfig(**train_config(arch, optimizer))
        opt, step_fn = make_train_step(model, tc)
        params = jax.tree.map(jnp.asarray, load_params(
            tmp, arch, model.param_specs()))
        state = {"params": params, "opt_state": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        state_sh = state_shardings(model, state, rules, mesh14)
        state = jax.device_put(state, state_sh)
        bs = batches(tmp, arch, tc.grad_accum)
        fn = jax.jit(step_fn, in_shardings=(
            state_sh, batch_shardings(mesh14, bs[0])), out_shardings=(
                state_sh, {"loss": rep14, "grad_norm": rep14, "lr": rep14}))
        metrics = []
        for b in bs:
            state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append([float(m["loss"]), float(m["grad_norm"]),
                            float(m["lr"])])
        res[f"metrics_{name}"] = np.array(metrics)
        for part in ("params", "opt_state"):
            for i, leaf in enumerate(jax.tree.leaves(state[part])):
                res[f"{part}_{name}_{i}"] = np.asarray(leaf)

    # moe_ep under shard_map: experts over "model", tokens over "data"
    for arch in MOE:
        with jax.enable_x64(arch in FLOAT64):
            cfg = ref_config(arch)
            data = dict(np.load(tmp / f"moe_{arch}.npz"))
            x, ct = jnp.asarray(data.pop("x")), jnp.asarray(data.pop("ct"))
            p = {k: jnp.asarray(v) for k, v in data.items()}
            specs = {k: P("model") if k in ("wi", "wg", "wo") else P()
                     for k in p}
            f = shard_map(lambda p, x: moe_ep(cfg, p, x, axis_name="model"),
                          mesh=mesh, in_specs=(specs, P("data")),
                          out_specs=P("data"), check_vma=False)
            res[f"moe_y_{arch}"] = np.asarray(jax.jit(f)(p, x))
            res[f"moe_gx_{arch}"] = np.asarray(jax.jit(jax.grad(
                lambda x: jnp.sum(f(p, x) * ct)))(x))

    # the tuple rule ("pod", "data") on a (2, 2, 1) mesh: each device's block
    mesh3 = Mesh(np.asarray(jax.devices()).reshape(2, 2, 1),
                 ("pod", "data", "model"))
    arr = jax.device_put(np.arange(48, dtype=np.float32).reshape(8, 6),
                         NamedSharding(mesh3, P(("pod", "data"), None)))
    for s in arr.addressable_shards:
        coord = np.argwhere(mesh3.devices == s.device)[0]
        res["tuple_" + "_".join(map(str, coord))] = np.asarray(s.data)

    # the port's checkpoint, saved on its (2, 2) mesh, read back here
    _wait_for(tmp / "ckpt_saved")
    like, sh = ckpt_like
    got = restore(tmp / "ckpt", 1, like, sh)
    d = tmp / "ckpt" / "step_00000001"
    info["ref_restore_equal"] = all(
        np.array_equal(np.asarray(a), np.load(d / f"leaf_{i:05d}.npy"))
        and a.sharding == s
        for i, (a, s) in enumerate(zip(jax.tree.leaves(got),
                                       jax.tree.leaves(sh))))
    np.savez(tmp / "ref.npz", **res)
    (tmp / "ref.json").write_text(json.dumps(info))


def _wait_for(path: Path, timeout: float = BOUND_S) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)


# ---------------------------------------------------------------------------
# the port: 4 gloo ranks


def _port_config(arch: str):
    """The reduced config, in float64 for the MoE pair (FLOAT64)."""
    from repro_torch.configs import get_config
    from repro_torch.models.conditioning import FLOAT64
    cut = ({"dtype": "float64", "cache_dtype": "float64"}
           if arch in FLOAT64 else {})
    return get_config(arch).reduced(**cut)


def _port_model(tmp: Path, arch: str):
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.transformer import TransformerLM
    model = TransformerLM(_port_config(arch), device="cpu")
    return params_from_reference(load_params(tmp, arch, model.param_specs()),
                                 model)


def _blocks_equal_files(state, d: Path) -> bool:
    """Every leaf's local block equal bit for bit to that block of the
    checkpoint's global array (and the same dtype)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import local_slices
    from repro_torch.tree import tree_leaves
    for i, leaf in enumerate(tree_leaves(state)):
        want = np.load(d / f"leaf_{i:05d}.npy")
        if isinstance(leaf, DTensor):
            want = want[local_slices(want.shape, leaf.device_mesh,
                                     leaf.placements)]
            leaf = leaf.to_local()
        got = leaf.detach().numpy()
        if got.dtype != want.dtype or not np.array_equal(got, want):
            return False
    return True


def _adamw_leaves(state, tag: str) -> dict:
    """The parameters and AdamW's moments of a mesh state, gathered into
    copies (a replicated leaf's `full_tensor` is its live local tensor,
    which the next step updates in place)."""
    from repro_torch.tree import tree_leaves
    trees = {"p": state["params"], "mu": state["opt_state"]["mu"],
             "nu": state["opt_state"]["nu"]}
    return {f"adamw_{tag}_{name}_{i}":
            leaf.full_tensor().detach().numpy().copy()
            for name, tree in trees.items()
            for i, leaf in enumerate(tree_leaves(tree))}


def _mesh_run(tmp: Path, arch: str, optimizer: str, mesh, rules=None,
              counted: bool = False) -> tuple:
    """(trainer, state, history, counts) of the case's STEPS steps on
    ``mesh``, a step a call of `Trainer.run`; with ``counted`` the first
    step runs under ``FlopCounterMode`` (counts: its FLOPs and the operand
    bytes of its all_reduces over "model", from the model's
    `ModelGroup`)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train import Trainer, TrainerConfig
    tc = TrainerConfig(**train_config(arch, optimizer, log_every=1))
    tr = Trainer(_port_model(tmp, arch), tc, mesh=mesh, rules=rules)
    state, hist, counts = tr.init_state(), [], {}
    for k, b in enumerate(batches(tmp, arch, tc.grad_accum)):
        if counted and k == 0:
            before = tr.model.tp.counts["all-reduce"]
            with FlopCounterMode(display=False) as fc:
                state, h = tr.run(state, iter([b]), 1)
            counts = {"flops": fc.get_total_flops(), "model_all_reduce":
                      tr.model.tp.counts["all-reduce"] - before}
        else:
            state, h = tr.run(state, iter([b]), 1)
        hist += h
    return tr, state, hist, counts


def _worker(rank: int, tmp: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import moe_ep
    from repro_torch.optim import compression
    from repro_torch.sharding.rules import (NamedSharding, ShardingRules,
                                            constrain, shard_like, use_mesh)
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.trainer import model_value, state_shardings
    from repro_torch.tree import tree_leaves

    torch.set_num_threads(1)
    _wait_for(tmp / "inputs_ready")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(model_axis=2, device_type="cpu")
        info = {"mesh": [list(mesh.mesh_dim_names), list(mesh.shape)],
                "data_mesh": list(make_host_mesh(device_type="cpu").shape),
                "coord": mesh.get_coordinate(), "placements": {}}
        res = {}
        # each compressed leaf's quantization level, a step after another
        levels = []
        quantize = compression.compress_int8

        def recording(g, error):
            q, scale, new_error = quantize(g, error)
            levels.append(float(scale.full_tensor() if isinstance(
                scale, DTensor) else scale))
            return q, scale, new_error
        compression.compress_int8 = recording
        for arch, optimizer in TRAIN:
            name = tag(arch, optimizer)
            model = _port_model(tmp, arch)
            tc = TrainerConfig(**train_config(arch, optimizer, log_every=1))
            tr = Trainer(model, tc, mesh=mesh)
            # a step a call of run: the parameters and moments after each
            # step, for test_adamw_steps_follow_the_update_with_decay
            state, hist = tr.init_state(), []
            levels.clear()
            for k, b in enumerate(batches(tmp, arch, tc.grad_accum)):
                if optimizer == "adamw":
                    res.update(_adamw_leaves(state, f"{name}_{k}"))
                state, h = tr.run(state, iter([b]), 1)
                hist += h
            if optimizer == "adamw":
                res.update(_adamw_leaves(state, f"{name}_{STEPS}"))
            if tc.grad_compression:
                res[f"levels_{name}"] = np.array(levels).reshape(STEPS, -1)
            res[f"metrics_{name}"] = np.array(
                [[h["loss"], h["grad_norm"], h["lr"]] for h in hist])
            info.setdefault("model_holds_state", []).append(all(
                torch.equal(p, model_value(v, how, mesh)) for p, v, how in
                zip(tree_leaves(model.param_tree()),
                    tree_leaves(state["params"]),
                    tree_leaves(model.split_plan))))
            info.setdefault("split_leaves", {})[name] = sum(
                isinstance(h, int) for h in tree_leaves(model.split_plan))
            leaves = tree_leaves(state)
            info["placements"][name] = [
                [repr(p) for p in x.placements] for x in leaves]
            want = tree_leaves(tr.state_shardings(state))
            info.setdefault("placed_as_state_shardings", []).append(all(
                tuple(x.placements) == s.placements
                for x, s in zip(leaves, want)))
            for part in ("params", "opt_state", "errors"):
                for i, leaf in enumerate(tree_leaves(state.get(part))):
                    res[f"{part}_{name}_{i}"] = leaf.full_tensor().numpy()
        compression.compress_int8 = quantize

        # the replicated step: the same cases with nothing split over
        # "model"; the counted first steps of the tensor-parallel one
        replicated = ShardingRules.default().with_overrides(
            heads=None, kv_heads=None, d_ff=None, vocab=None)
        for arch, optimizer in TRAIN:
            name = tag(arch, optimizer)
            tr, _, hist, _ = _mesh_run(tmp, arch, optimizer, mesh,
                                       replicated)
            info.setdefault("replicated_split_leaves", []).append(
                tr.model.tp is None)
            res[f"metrics_rep_{name}"] = np.array(
                [[h["loss"], h["grad_norm"], h["lr"]] for h in hist])
        for arch, optimizer in COUNTED:
            *_, counts = _mesh_run(tmp, arch, optimizer, mesh, counted=True)
            info.setdefault("counts", {})[tag(arch, optimizer)] = counts

        # qwen3-0.6b, zamba2-7b and whisper-base on (1, 4): every rank's q
        # head block, kv heads whole
        mesh14 = init_device_mesh("cpu", (1, 4),
                                  mesh_dim_names=("data", "model"))
        for arch, optimizer in [TP14] + FAMILIES14:
            name = tag(arch, optimizer) + "-14"
            _, state, hist, _ = _mesh_run(tmp, arch, optimizer, mesh14)
            res[f"metrics_{name}"] = np.array(
                [[h["loss"], h["grad_norm"], h["lr"]] for h in hist])
            for part in ("params", "opt_state"):
                for i, leaf in enumerate(tree_leaves(state[part])):
                    res[f"{part}_{name}_{i}"] = leaf.full_tensor().numpy()

        # the elastic restore: one step on (2, 2), saved; restored onto
        # (4, 1), which takes the second step
        ckpt = tmp / "ckpt"
        model = _port_model(tmp, CKPT_ARCH)
        tc = TrainerConfig(**trainer_config("adamw", ckpt_dir=str(ckpt),
                                            ckpt_every=1))
        tr = Trainer(model, tc, mesh=mesh)
        tr.run(tr.init_state(), iter(batches(tmp, CKPT_ARCH)[:1]), 1)
        info["latest"] = tr.ckpt.latest()
        info["saves"] = [s["step"] for s in tr.ckpt.saves]
        # a state saved from a model split over "model" (its blocks
        # gathered into global arrays)
        tcz = TrainerConfig(**trainer_config(
            "adamw", ckpt_dir=str(tmp / "ckpt_split"), ckpt_every=1))
        trz = Trainer(_port_model(tmp, SPLIT_CKPT_ARCH), tcz, mesh=mesh)
        trz.run(trz.init_state(),
                iter(batches(tmp, SPLIT_CKPT_ARCH)[:1]), 1)
        info["split_ckpt_leaves"] = sum(
            isinstance(h, int) for h in tree_leaves(trz.model.split_plan))
        dist.barrier()
        if rank == 0:
            (tmp / "ckpt_saved").write_text("ok")
        mesh41 = init_device_mesh("cpu", (4, 1),
                                  mesh_dim_names=("data", "model"))
        tr41 = Trainer(_port_model(tmp, CKPT_ARCH), tc, mesh=mesh41)
        state = tr41.restore_or_init()
        info["restored_41_step"] = int(state["step"])
        info["restored_41_equal"] = _blocks_equal_files(
            state, ckpt / "step_00000001")
        info["restored_41_placed"] = all(
            tuple(x.placements) == s.placements for x, s in zip(
                tree_leaves(state), tree_leaves(state_shardings(
                    tr41.model, state, tr41.rules, mesh41))))
        trz41 = Trainer(_port_model(tmp, SPLIT_CKPT_ARCH), tcz, mesh=mesh41)
        state_z = trz41.restore_or_init()
        info["split_restored_41_step"] = int(state_z["step"])
        info["split_restored_41_equal"] = _blocks_equal_files(
            state_z, tmp / "ckpt_split" / "step_00000001")
        del state_z
        state, m = tr41._step_fn(state, {
            k: torch.from_numpy(v)
            for k, v in batches(tmp, CKPT_ARCH)[1].items()})
        res["resumed_metrics"] = np.array(
            [float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
        for i, leaf in enumerate(tree_leaves(state["params"])):
            res[f"resumed_params_{tag(CKPT_ARCH, 'adamw')}_{i}"] = (
                leaf.full_tensor().numpy())

        # moe_ep: this rank's tokens (its "data" coordinate) and experts
        # (its "model" coordinate)
        di, mi = mesh.get_coordinate()
        for arch in MOE:
            cfg = _port_config(arch)
            data = {k: torch.from_numpy(v)
                    for k, v in np.load(tmp / f"moe_{arch}.npz").items()}
            x, ct = data.pop("x"), data.pop("ct")
            rows = slice(di * x.shape[0] // 2, (di + 1) * x.shape[0] // 2)
            e = cfg.num_experts // 2
            p = {k: v[mi * e:(mi + 1) * e] if k in ("wi", "wg", "wo") else v
                 for k, v in data.items()}
            xl = x[rows].clone().requires_grad_(True)
            y = moe_ep(cfg, p, xl, group=mesh)
            (y * ct[rows]).sum().backward()
            res[f"moe_y_{arch}"] = y.detach().numpy()
            res[f"moe_gx_{arch}"] = xl.grad.numpy()

        # constrain inside use_mesh; a tuple rule's blocks
        logits = distribute_tensor(torch.ones(BATCH, 8, 16), mesh,
                                   [Replicate(), Replicate()])
        with use_mesh(mesh):
            info["constrained"] = [repr(p) for p in constrain(
                logits, ("batch", None, "act_vocab")).placements]
            plain = torch.ones(2, 3)
            info["constrain_plain_identity"] = constrain(
                plain, ("batch", None)) is plain
        info["constrain_outside"] = isinstance(
            constrain(logits, ("batch", None, "act_vocab")), DTensor)
        mesh3 = init_device_mesh("cpu", (2, 2, 1),
                                 mesh_dim_names=("pod", "data", "model"))
        block = shard_like(
            torch.arange(48, dtype=torch.float32).reshape(8, 6),
            NamedSharding(mesh3, (("pod", "data"), None)))
        res["tuple_" + "_".join(map(str, mesh3.get_coordinate()))] = (
            block.to_local().numpy())
        np.savez(tmp / f"port_{rank}.npz", **res)
        (tmp / f"port_{rank}.json").write_text(json.dumps(info))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the port alone: the (1, 1) mesh and the restore onto (1, 1) and no mesh


def _single(tmp: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    torch.set_num_threads(1)
    _wait_for(tmp / "inputs_ready")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store_single"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        info = {"bitwise": {}}
        for arch, optimizer in SINGLE:
            kw = trainer_config(optimizer, log_every=1)
            runs = []
            for m in (None, mesh):
                tr = Trainer(_port_model(tmp, arch), TrainerConfig(**kw),
                             mesh=m)
                state, hist = tr.run(tr.init_state(), iter(batches(
                    tmp, arch, kw.get("grad_accum", 1))), STEPS)
                leaves = [x.full_tensor() if m is not None else x
                          for x in tree_leaves(state)]
                runs.append((hist, leaves, tree_leaves(tr.model.param_tree())))
            (h1, s1, m1), (h2, s2, m2) = runs
            info["bitwise"][f"{arch}/{optimizer}"] = {
                "metrics": [[a[k] == b[k] for k in ("loss", "grad_norm",
                                                    "lr")]
                            for a, b in zip(h1, h2)],
                "state": len(s1) == len(s2) and all(
                    a.dtype == b.dtype and torch.equal(a.detach(), b)
                    for a, b in zip(s1, s2)),
                "model": len(m1) == len(m2) and all(
                    torch.equal(a, b) for a, b in zip(m1, m2))}

        # moe_ep over this one rank, every expert, each data row's tokens
        from repro_torch.models.moe import moe_ep
        res = {}
        for arch in MOE:
            cfg = _port_config(arch)
            data = {k: torch.from_numpy(v)
                    for k, v in np.load(tmp / f"moe_{arch}.npz").items()}
            x, ct = data.pop("x"), data.pop("ct")
            half = x.shape[0] // 2
            for di in range(2):
                rows = slice(di * half, (di + 1) * half)
                xl = x[rows].clone().requires_grad_(True)
                y = moe_ep(cfg, data, xl, group=dist.group.WORLD)
                (y * ct[rows]).sum().backward()
                res[f"moe_y_{arch}_{di}"] = y.detach().numpy()
                res[f"moe_gx_{arch}_{di}"] = xl.grad.numpy()
        np.savez(tmp / "single.npz", **res)

        _wait_for(tmp / "ckpt_saved")
        ckpt = tmp / "ckpt"
        tc = TrainerConfig(**trainer_config("adamw", ckpt_dir=str(ckpt)))
        for name, m in (("11", mesh), ("none", None)):
            tr = Trainer(_port_model(tmp, CKPT_ARCH), tc, mesh=m)
            state = tr.restore_or_init()
            info[f"restored_{name}_step"] = int(state["step"])
            info[f"restored_{name}_equal"] = _blocks_equal_files(
                state, ckpt / "step_00000001")
        tcz = TrainerConfig(**trainer_config(
            "adamw", ckpt_dir=str(tmp / "ckpt_split")))
        for name, m in (("11", mesh), ("none", None)):
            tr = Trainer(_port_model(tmp, SPLIT_CKPT_ARCH), tcz, mesh=m)
            state = tr.restore_or_init()
            info[f"split_restored_{name}_step"] = int(state["step"])
            info[f"split_restored_{name}_equal"] = _blocks_equal_files(
                state, tmp / "ckpt_split" / "step_00000001")
        (tmp / "single.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the module's one run of all sides


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # once per session: under xdist the workers share the session's base
    # directory, and the first to take the lock runs both sides for all
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    tmp = base / "torch_mesh_train"
    with open(base / "torch_mesh_train.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (tmp / "done").exists():
                tmp.mkdir(exist_ok=True)
                try:
                    _run_all_sides(tmp)
                    (tmp / "done").write_text("ok")
                except BaseException as e:
                    (tmp / "done").write_text(f"failed: {e}")
                    raise
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    done = (tmp / "done").read_text()
    assert done == "ok", done
    ports = [dict(np.load(tmp / f"port_{r}.npz")) for r in range(WORLD)]
    infos = [json.loads((tmp / f"port_{r}.json").read_text())
             for r in range(WORLD)]
    return {"ref": dict(np.load(tmp / "ref.npz")),
            "ref_info": json.loads((tmp / "ref.json").read_text()),
            "ports": ports, "infos": infos,
            "single": json.loads((tmp / "single.json").read_text()),
            "tmp": tmp}


def _run_all_sides(tmp: Path) -> None:
    # a crash of a subprocess prints its Python stack to its log
    base = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONFAULTHANDLER": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT / "src"), str(ROOT / "tests"),
                 os.environ.get("PYTHONPATH", "")])}
    me = [sys.executable, str(Path(__file__).resolve())]
    jobs = [("reference", {**base, "JAX_PLATFORMS": "cpu",
                           "XLA_FLAGS": "--xla_force_host_platform_device_"
                                        f"count={WORLD}"}),
            ("single", base)]
    jobs += [(f"worker {r}", base) for r in range(WORLD)]
    procs = []
    for name, env in jobs:
        log = tmp / f"{name.replace(' ', '_')}.log"
        with open(log, "w") as f:
            procs.append((name, log, subprocess.Popen(
                [*me, *name.split(), str(tmp)], env=env, stdout=f,
                stderr=subprocess.STDOUT)))
    deadline = time.monotonic() + BOUND_S
    failed = []
    try:
        for name, log, proc in procs:
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timed out"
            if rc:
                failed.append(f"{name}: {rc}\n{log.read_text()[-3000:]}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not failed, "\n".join(failed)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


# ---------------------------------------------------------------------------
# the sharded steps against the reference's


def reference_spread(ref: dict, arch: str) -> np.ndarray:
    """(STEPS, 3): |(2, 2) - (1, 4)| / |(2, 2)| of the reference's own
    steps of ``arch`` (AdamW) in this run."""
    a, b = ref[f"metrics_{tag(arch, 'adamw')}"], ref[
        f"metrics_{tag(arch, 'adamw')}-14"]
    return np.abs(a - b) / np.abs(a)


def metric_bounds(arch: str, ref: dict) -> np.ndarray:
    """(STEPS, 3): each step's bound on |port - ref| / |ref| of the loss,
    grad norm and lr: TOL_METRIC, but at the (step, metric)s of SPREAD
    the reference's own spread between its meshes where that is
    larger."""
    out = np.full((STEPS, 3), TOL_METRIC)
    if arch in SPREAD:
        spread = reference_spread(ref, arch)
        for at in SPREAD[arch]:
            out[at] = max(TOL_METRIC, spread[at])
    return out


def check_leaves(got: dict, ref: dict, key: str, bound: float,
                 adamw: bool = False, flip_lr: float | None = None
                 ) -> None:
    """The leaves ``<key>_<i>`` of ``got`` against ``ref``'s: within
    ``bound`` of the leaf's max |ref|, or (``adamw``) every entry within
    TOL_ADAMW_LR * LR of it; with ``flip_lr`` all but fewer than
    ADAMW_FLIP_SHARE of a leaf's entries within TOL_ADAMW_LR * LR, and
    those within ``flip_lr`` * LR."""
    n = len([k for k in ref if k.startswith(f"{key}_")])
    assert n and n == len([k for k in got if k.startswith(f"{key}_")])
    for i in range(n):
        g, w = got[f"{key}_{i}"], ref[f"{key}_{i}"]
        assert g.shape == w.shape and g.dtype == w.dtype
        if adamw:
            diff = np.abs(g.astype(np.float64) - w)
            if flip_lr is None:
                assert diff.max() <= TOL_ADAMW_LR * LR, i
            else:
                flips = int((diff > TOL_ADAMW_LR * LR).sum())
                assert flips < ADAMW_FLIP_SHARE * diff.size, (i, flips)
                assert diff.max() <= flip_lr * LR, i
        else:
            assert rel(g, w) < bound, i


def check_flips(got: dict, ref: dict, key: str, levels) -> None:
    """The leaves ``<key>_<i>`` of a compressed SGD state (momentum or int8
    error) against ``ref``'s. A step's int8 rounding of a value within the
    two packages' difference of a half level flips it by one level, which
    the error feedback carries and the momentum sums: an entry that moved
    by more than FLIP_FLOOR of its leaf's levels (the sum over the steps
    of ``levels[:, i]``, leaf i's scales; the other entries measured at
    most 3.1e-3 of them) is a flip. Flips are fewer than MOE_FLIP_SHARE of
    the compressed entries (measured 2.0e-5 of the momentum's and 4.4e-5
    of the errors'), each within the sum of the levels (measured 0.64 of
    it). A leaf past the compressed ones (the step) is held exactly."""
    n = len([k for k in ref if k.startswith(f"{key}_")])
    assert n and n == len([k for k in got if k.startswith(f"{key}_")])
    flips = entries = 0
    for i in range(n):
        g, w = got[f"{key}_{i}"], ref[f"{key}_{i}"]
        assert g.shape == w.shape and g.dtype == w.dtype
        if i >= levels.shape[1]:
            assert np.array_equal(g, w), i
            continue
        level = levels[:, i].sum()
        d = np.abs(g.astype(np.float64) - w)
        flips += int((d > FLIP_FLOOR * level).sum())
        entries += d.size
        assert d.max() <= level * (1 + TOL_METRIC), i
    assert flips < MOE_FLIP_SHARE * entries


@pytest.mark.parametrize("arch,optimizer", TRAIN)
def test_mesh_steps_match_the_reference(runs, arch, optimizer):
    """Each step's loss, grad norm and lr within 1e-5 of the reference's
    sharded step (measured at most 1.9e-6 for the G/L families; rwkv6-3b
    6.3e-6, whisper-base 1.5e-7, zamba2-7b's first step 3.6e-6), on every
    rank; zamba2-7b's grad norm after its first step (measured 2.2e-5)
    within the reference's own steps' spread there, its (2, 2) against
    its (1, 4) in this run (SPREAD; measured 5.7e-5, its (2, 2) and
    (4, 1) 2.3e-5): TOL_METRIC is not met there, by the reference
    either. AdamW's first update moves an entry whose gradient is within
    rounding of zero by +-lr on its sign, and zamba2's gradient at the
    moved parameters follows them: its grad norm falls 13% in that one
    step.

    After step 2 every optimizer-state leaf within STATE_BOUND of its max:
    AdamW's moments measured 4.6e-5 (qwen2-0.5b), 5.2e-5 (gemma3-1b) and
    2.6e-6 (qwen3-0.6b); mixtral's adafactor statistics 3.9e-4 (the
    second moment of the norm scale before its MoE, whose input gradient
    carries the bf16 rounding flips of test_moe_ep_matches_the_reference;
    the reference's own unsharded step differs from its sharded one there
    by 9.5e-5). Adafactor's and SGD's parameters within 1e-4 (measured
    1.1e-5 and 3.3e-6). AdamW's first steps move each entry by about lr
    times the sign of its gradient, so an entry whose gradient is near
    zero moves by up to 2 lr on a rounding: its parameters are held within
    0.2 lr (measured 0.110 lr for qwen2-0.5b, 0.038 lr for gemma3-1b and
    0.015 lr for qwen3-0.6b; the reference's own unsharded step differs
    from its sharded one by 0.053 lr and 0.106 lr). rwkv6-3b, unconditioned
    (it has no wq or wk), and zamba2-7b are held at the reference's own
    spread between its meshes: its (2, 2) and (1, 4) steps differ by 9.9e-4
    and 1.5e-3 in the moments and 0.27 lr and 1.42 lr in the parameters,
    and the port measured 1.1e-3 and 1.3e-3 (2.7e-3 on (1, 4)), 0.47 lr
    and 1.43 lr: STATE_BOUND 3e-3 and 5e-3. Their parameters are held as
    flips: in every leaf all but fewer than ADAMW_FLIP_SHARE 1e-3 of the
    entries within 0.2 lr (measured at most 5e-5 of a leaf, 1-3 entries
    of 32768-65536 in 2 of 26 and 2 of 70 leaves), those within
    ADAMW_LR_BOUND 1 lr and 2 lr, a sign flipped by a rounding; an update
    dropped or applied twice moves every entry of its leaf by about lr.
    whisper-base's moments measured
    9.2e-6 and its parameters 0.018 lr. Compressed SGD's
    momentum and int8 error state are held by `check_flips`. qwen3-0.6b
    accumulates two microbatches a step, the microbatch axis first and
    unsharded on both sides."""
    ref, name = runs["ref"], tag(arch, optimizer)
    for port in runs["ports"]:
        got, want = port[f"metrics_{name}"], ref[f"metrics_{name}"]
        assert got.shape == want.shape == (STEPS, 3)
        assert np.all(np.abs(got - want)
                      <= metric_bounds(arch, ref) * np.abs(want))
        if optimizer == "sgd":
            levels = port[f"levels_{name}"]
            check_flips(port, ref, f"opt_state_{name}", levels)
            check_flips(port, ref, f"errors_{name}", levels)
        else:
            check_leaves(port, ref, f"opt_state_{name}", STATE_BOUND[arch])
        check_leaves(port, ref, f"params_{name}", TOL_PARAM,
                     adamw=optimizer == "adamw",
                     flip_lr=ADAMW_LR_BOUND.get(arch))


@pytest.mark.parametrize("arch,optimizer", TRAIN, ids=case_ids(TRAIN))
def test_tensor_parallel_step_matches_the_replicated_step(runs, arch,
                                                          optimizer):
    """On (2, 2), each step's loss, grad norm and lr of the tensor-parallel
    step (the default rules split heads, d_ff and vocab over "model", and
    kv_heads where they divide) within 1e-5 of the replicated step's (the
    rules with heads, kv_heads, d_ff and vocab overridden to None, which
    split nothing there), on every rank; zamba2-7b's grad norm after its
    first step within the reference's own spread of SPREAD (measured
    1.2e-5; the replicated step is 3.4e-5 from the reference's, the split
    one 2.2e-5)."""
    name = tag(arch, optimizer)
    for port, info in zip(runs["ports"], runs["infos"]):
        assert info["split_leaves"][name] > 0
        assert all(info["replicated_split_leaves"])
        got, want = port[f"metrics_{name}"], port[f"metrics_rep_{name}"]
        assert got.shape == want.shape == (STEPS, 3)
        assert np.all(np.abs(got - want)
                      <= metric_bounds(arch, runs["ref"]) * np.abs(want))


def test_one_by_four_mesh_matches_the_reference(runs):
    """qwen3-0.6b on (1, 4): its 4 q heads one a rank, its 2 kv heads
    whole (each rank reads the one its q head's group holds), at the
    bounds of test_mesh_steps_match_the_reference against the
    reference's step on a (1, 4) mesh."""
    ref, name = runs["ref"], tag(*TP14) + "-14"
    for port in runs["ports"]:
        got, want = port[f"metrics_{name}"], ref[f"metrics_{name}"]
        assert got.shape == want.shape == (STEPS, 3)
        assert np.all(np.abs(got - want) <= TOL_METRIC * np.abs(want))
        check_leaves(port, ref, f"opt_state_{name}", STATE_BOUND[TP14[0]])
        check_leaves(port, ref, f"params_{name}", TOL_PARAM, adamw=True)


@pytest.mark.parametrize("arch,optimizer", FAMILIES14,
                         ids=[a for a, _ in FAMILIES14])
def test_one_by_four_mesh_matches_the_reference_for_the_families(
        runs, arch, optimizer):
    """zamba2-7b (its shared attention block's 4 q heads one a rank, its 2
    kv heads whole; its mamba blocks' 8 heads two a rank) and whisper-base
    (the encoder's, the decoder's and the cross attention's 4 q heads one
    a rank, their 2 kv heads whole) on (1, 4), at the bounds of
    test_mesh_steps_match_the_reference against the reference's step on a
    (1, 4) mesh (zamba2-7b's grad norm after its first step measured
    1.7e-5)."""
    ref, name = runs["ref"], tag(arch, optimizer) + "-14"
    for port in runs["ports"]:
        got, want = port[f"metrics_{name}"], ref[f"metrics_{name}"]
        assert got.shape == want.shape == (STEPS, 3)
        assert np.all(np.abs(got - want)
                      <= metric_bounds(arch, ref) * np.abs(want))
        check_leaves(port, ref, f"opt_state_{name}", STATE_BOUND[arch])
        check_leaves(port, ref, f"params_{name}", TOL_PARAM, adamw=True,
                     flip_lr=ADAMW_LR_BOUND.get(arch))


@pytest.mark.parametrize("arch", sorted(SPREAD))
def test_the_metric_spread_bound_is_the_references_own(runs, arch):
    """Where SPREAD holds a metric at the reference's own spread between
    its (2, 2) and (1, 4) steps, that spread, measured in this run, is
    past TOL_METRIC (which the reference itself does not meet there;
    zamba2-7b's grad norm after its first step: 5.7e-5) and below
    SPREAD_CAP, so that the bound cannot widen unseen; everywhere else
    the reference's meshes agree within TOL_METRIC."""
    spread = reference_spread(runs["ref"], arch)
    at = tuple(zip(*SPREAD[arch]))
    assert np.all(spread[at] > TOL_METRIC)
    assert np.all(spread[at] < SPREAD_CAP)
    rest = np.ones_like(spread, dtype=bool)
    rest[at] = False
    assert np.all(spread[rest] <= TOL_METRIC)


ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "wd": 0.1}  # the defaults
# the residual of a step against AdamW's update, over its decay term
TOL_DECAY = 1e-2


@pytest.mark.parametrize("arch", [a for a, o in TRAIN if o == "adamw"])
def test_adamw_steps_follow_the_update_with_decay(runs, arch):
    """Each mesh step's new parameters against AdamW's update computed in
    float64 from the step's own old parameters and new moments (held to
    the reference's above within STATE_BOUND):
    p - lr * (mh / (sqrt(vh) + eps) + wd * p). The residual of every leaf
    stays within TOL_DECAY of its largest decay term lr * wd * max |p|,
    so a decay left out or applied twice fails, which the 0.2 lr bound on
    the parameters alone cannot see where wd * |p| is below 0.2."""
    port, ref, name = runs["ports"][0], runs["ref"], tag(arch, "adamw")
    lrs = port[f"metrics_{name}"][:, 2]
    n = len([k for k in port if k.startswith(f"adamw_{name}_0_p_")])
    assert n == len([k for k in ref if k.startswith(f"params_{name}_")])
    b1, b2, eps, wd = ADAMW["b1"], ADAMW["b2"], ADAMW["eps"], ADAMW["wd"]
    for k in range(1, STEPS + 1):
        lr = float(lrs[k - 1])
        for i in range(n):
            old = port[f"adamw_{name}_{k - 1}_p_{i}"].astype(np.float64)
            new = port[f"adamw_{name}_{k}_p_{i}"].astype(np.float64)
            mh = port[f"adamw_{name}_{k}_mu_{i}"] / (1.0 - b1 ** k)
            vh = port[f"adamw_{name}_{k}_nu_{i}"] / (1.0 - b2 ** k)
            want = old - lr * (mh / (np.sqrt(vh) + eps) + wd * old)
            decay = lr * wd * np.abs(old).max()
            assert np.abs(new - want).max() <= TOL_DECAY * decay, (k, i)


def test_the_model_holds_the_trained_weights_after_a_mesh_run(runs):
    """After `Trainer.run` on a mesh the model's parameters are the
    state's (this rank's block along "model" of each leaf the model holds
    split), on every rank of (2, 2), and on (1, 1) bit for bit the
    one-device trainer's model after the same steps."""
    for info in runs["infos"]:
        assert info["model_holds_state"] == [True] * len(TRAIN)
    for case, r in runs["single"]["bitwise"].items():
        assert r["model"], case


@pytest.mark.parametrize("arch,optimizer", TRAIN, ids=case_ids(TRAIN))
def test_mesh_state_placements_match_the_reference_specs(runs, arch,
                                                         optimizer):
    """Every leaf of the trained state (params, moments or factored stats,
    compression errors, steps) a DTensor with the placements the
    reference's spec of that leaf names, on every rank."""
    from torch.distributed.tensor import Replicate, Shard
    names = ("data", "model")
    for info in runs["infos"]:
        assert all(info["placed_as_state_shardings"])
        got = info["placements"][tag(arch, optimizer)]
        specs = runs["ref_info"]["specs"][tag(arch, optimizer)]
        assert len(got) == len(specs)
        for pl, spec in zip(got, specs):
            want = []
            for n in names:
                dims = [i for i, e in enumerate(spec) if e is not None
                        and n in ([e] if isinstance(e, str) else e)]
                want.append(repr(Shard(dims[0]) if dims else Replicate()))
            assert pl == want


def test_the_host_mesh_and_every_rank_coordinate(runs):
    infos = runs["infos"]
    assert all(i["mesh"] == [["data", "model"], [2, 2]] for i in infos)
    assert all(i["data_mesh"] == [WORLD] for i in infos)
    assert sorted(tuple(i["coord"]) for i in infos) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_one_by_one_mesh_equals_one_device_bit_for_bit(runs):
    """The (1, 1) mesh's losses, grad norms, lr and every state leaf equal
    the one-device trainer's, for adamw, adafactor and accumulated,
    compressed SGD."""
    got = runs["single"]["bitwise"]
    assert sorted(got) == sorted(f"{a}/{o}" for a, o in SINGLE)
    for case, r in got.items():
        assert r["metrics"] == [[True] * 3] * STEPS, case
        assert r["state"], case


# ---------------------------------------------------------------------------
# checkpoints: saved on (2, 2), restored elsewhere


def test_elastic_restore_is_bit_for_bit_on_every_mesh(runs):
    """The state saved on (2, 2) after one step: onto (4, 1) (every rank's
    blocks), (1, 1) and no mesh, each leaf equal to the saved global
    array; the reference's restore onto its (2, 2) shardings too."""
    single = runs["single"]
    for info in runs["infos"]:
        assert info["latest"] == 1 and info["saves"] == [1]
        assert info["restored_41_step"] == 1
        assert info["restored_41_equal"] and info["restored_41_placed"]
    for name in ("11", "none"):
        assert single[f"restored_{name}_step"] == 1
        assert single[f"restored_{name}_equal"]
    assert runs["ref_info"]["ref_restore_equal"]
    d = runs["tmp"] / "ckpt"
    assert sorted(p.name for p in d.glob("step_*")) == ["step_00000001"]
    assert (d / "step_00000001" / "COMMIT").exists()


def test_split_model_state_restores_bit_for_bit_on_every_mesh(runs):
    """zamba2-7b's state saved on (2, 2) after one step, from a model that
    holds its blocks along "model" (the mamba blocks, the shared attention
    block and the vocabulary split): onto (4, 1) (every rank's blocks),
    (1, 1) and no mesh, each leaf equal to the saved global array."""
    single = runs["single"]
    for info in runs["infos"]:
        assert info["split_ckpt_leaves"] > 0
        assert info["split_restored_41_step"] == 1
        assert info["split_restored_41_equal"]
    for name in ("11", "none"):
        assert single[f"split_restored_{name}_step"] == 1
        assert single[f"split_restored_{name}_equal"]
    d = runs["tmp"] / "ckpt_split"
    assert sorted(p.name for p in d.glob("step_*")) == ["step_00000001"]


def test_resumed_step_on_another_mesh_matches_the_uninterrupted_run(runs):
    """Step 2 on (4, 1) from the (2, 2) checkpoint of step 1: within the
    bounds above of the reference's uninterrupted two steps."""
    ref, name = runs["ref"], tag(CKPT_ARCH, "adamw")
    want = ref[f"metrics_{name}"][1]
    for port in runs["ports"]:
        got = port["resumed_metrics"]
        assert np.all(np.abs(got - want) <= TOL_METRIC * np.abs(want))
        check_leaves({k.replace("resumed_", ""): v for k, v in port.items()
                      if k.startswith("resumed_params_")}, ref,
                     f"params_{name}", TOL_PARAM, adamw=True)


# ---------------------------------------------------------------------------
# moe_ep, constrain, a tuple rule's blocks


@pytest.mark.parametrize("arch", MOE)
def test_moe_ep_matches_the_reference(runs, arch):
    """Every rank's forward within 1e-5 of the reference's moe_ep under
    shard_map (measured 2.0e-7), and its input gradient within 1e-5 but
    at the entries a bf16 rounding flip reaches. The reference routes in
    float32 (in a float64 model too): the two packages' routing weights
    differ by ~3e-7, and the backward pass rounds cotangents carrying
    them to bf16 (the exchanged buffers, the dispatch product), so an
    entry within that of a rounding boundary flips by one bf16 ulp of a
    term. Those are held to fewer than 1% of the entries and within 2^-8
    of max |ref| (mixtral: 27 of 4096 entries of two ranks, one token,
    2.5e-3; llama4-scout: none, 1.5e-7). The reference is bitwise the
    same on (2, 2) and (2, 1); the port's distribution is held bit for
    bit by test_moe_ep_over_the_mesh_equals_one_rank."""
    ref = runs["ref"]
    half = MOE_SHAPE[0] // 2
    for port, info in zip(runs["ports"], runs["infos"]):
        di = info["coord"][0]
        want = ref[f"moe_y_{arch}"][di * half:(di + 1) * half]
        got = port[f"moe_y_{arch}"]
        assert got.shape == want.shape and rel(got, want) < TOL_MOE
        want = ref[f"moe_gx_{arch}"][di * half:(di + 1) * half]
        got = port[f"moe_gx_{arch}"]
        assert got.shape == want.shape
        d = np.abs(got - want) / np.abs(want).max()
        assert (d > TOL_MOE).mean() < MOE_FLIP_SHARE
        assert d.max() < MOE_FLIP_BOUND


@pytest.mark.parametrize("arch", MOE)
def test_moe_ep_over_the_mesh_equals_one_rank(runs, arch):
    """moe_ep on (2, 2), experts split over "model", against moe_ep over a
    world-size-1 group holding every expert, on the same data row's
    tokens (the same capacity): forward and input gradient bit for bit;
    the two ranks of a data row agree bit for bit too."""
    single = dict(np.load(runs["tmp"] / "single.npz"))
    for port, info in zip(runs["ports"], runs["infos"]):
        di = info["coord"][0]
        for name in ("moe_y", "moe_gx"):
            assert np.array_equal(port[f"{name}_{arch}"],
                                  single[f"{name}_{arch}_{di}"]), name


def test_constrain_redistributes_a_dtensor_inside_use_mesh(runs):
    for info in runs["infos"]:
        assert info["constrained"] == ["Shard(dim=0)", "Shard(dim=2)"]
        assert info["constrain_plain_identity"]
        assert info["constrain_outside"]


def test_tuple_rule_blocks_are_the_reference_devices_blocks(runs):
    """("pod", "data") on a (2, 2, 1) mesh: each rank's block is the one
    JAX gives the device at the same mesh coordinate."""
    ref = runs["ref"]
    keys = [k for k in ref if k.startswith("tuple_")]
    assert len(keys) == WORLD
    got = {}
    for port in runs["ports"]:
        got.update((k, v) for k, v in port.items() if k.startswith("tuple_"))
    assert sorted(got) == sorted(keys)
    for k in keys:
        assert np.array_equal(got[k], ref[k]), k


if __name__ == "__main__":
    role, *args = sys.argv[1:]
    if role == "reference":
        _reference(Path(args[0]))
    elif role == "single":
        _single(Path(args[0]))
    else:
        _worker(int(args[0]), Path(args[1]))
