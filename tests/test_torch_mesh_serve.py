"""The port's prefill and decode split over "model" (`TransformerLM.prefill`,
`decode_step` and `ServeEngine.generate` on a model that
`split_over_model` cut to a rank's blocks) against the JAX package's
sharded ``prefill`` and ``decode_step`` on 4 forced host devices, and
against the unsplit port.

Both sides run once per test session, in subprocesses of this file,
started together:

* the reference (``python test_torch_mesh_serve.py reference <dir>``,
  with XLA_FLAGS=--xla_force_host_platform_device_count=4 set before JAX
  is imported) makes the inputs, then on Auto-axes (2, 2) and (1, 4)
  ("data", "model") ``jax.sharding.Mesh`` es (``make_host_mesh``'s
  Explicit axes raise ``ShardingTypeError`` at the embedding gather) runs
  ``jax.jit(lambda p, b: model.prefill(p, b, cache_len=L),
  in_shardings=(param_shardings, batch shardings))`` and 4 steps of
  ``jax.jit(model.decode_step, in_shardings=(param_shardings,
  tree_shardings(caches, cache_axes()), token, position))``, the
  shardings of ``repro/launch/dryrun.py``'s prefill and decode cells;
* 4 workers of the port (``... worker <rank> <dir>``) in one ``gloo``
  group, on the same meshes: the model split over "model"
  (`split_over_model`, the default rules), each rank's batch rows (its
  "data" coordinate's), the same prefill and decode steps, then
  `ServeEngine.generate` on the split model; on (2, 2) rank 0 also
  counts the FLOPs and the all_reduce operand bytes over "model" of the
  prefill and decode cells of `COUNTED_SHAPES` (test_torch_lm_dryrun
  holds the meta cells to them).

The configs (`ARCHS`) are reduced; batch 4, a prompt of 96 tokens (past
the reduced window of 64, so the L layers write a rotated ring at
prefill; 2 x 96 and 4 x 96 tokens are whole MoE groups of 64 on every
data rank), 4 decode steps teacher-forced with seeded tokens. Both
packages take the reference's ``init_params`` with its zeros and ones
leaves redrawn and, for the configs of `conditioning.GRAD_CONDITIONED`,
wq and wk at their true fan-in, carried over by `models/convert.py`; the
MoE configs compute in float64 (`models.conditioning`). A forward split
over "model" sums its row-parallel products over the ranks, and that
rounding moves the unconditioned softmaxes of those configs as it moves
their gradients (the reduced zamba2-7b's logits over 4 ranks: 3.7e-5
from the unsplit port's unconditioned, 4.7e-6 conditioned).

Each rank's prefill logits (its block of the vocabulary), its decode
steps' logits and each cache leaf's block (`cache_split`, `cache_block`;
its rows along the batch) after prefill and after the last step are held
to the reference's arrays and to the unsplit port's within `TOL` of
max |reference| (`TOL_MOE_REF` for the MoE pair against the reference:
its bf16 dispatch). On (1, 4) the reduced
configs' 2 kv heads stay whole under 4 q heads, where the reference
shards the caches' ``head_dim`` instead (the rules' ``cache_head_dim``
fallback): the port's cache holds the kv heads its q heads read, one
here. The split engine's greedy tokens equal the unsplit engine's, the
same on every rank of "model".

Every process group has a 60 s timeout and the subprocesses a bound
(`BOUND_S`); they run with ``PYTHONFAULTHANDLER=1``, and a failure prints
the tail of each failed process's log. Under xdist the first worker to
take a lock runs all of it and the others read its results. The
workers import no JAX.
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

from test_torch_mesh_train import _wait_for, load_params

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"22": (2, 2), "14": (1, 4)}
ARCHS = ("qwen2-0.5b", "gemma3-1b", "mixtral-8x22b", "internvl2-2b",
         "whisper-base", "rwkv6-3b", "zamba2-7b")
BATCH, PROMPT, STEPS, NEW = 4, 96, 4, 4
FRAMES = 64  # the reference launcher's stub frames
# max |port - ref| / max |ref| of a logits block or a cache block, the
# same against the unsplit port: measured up to 7.2e-6 against the
# reference and 4.7e-6 against the unsplit port (zamba2-7b on (1, 4): its
# mamba norm's mean of squares summed over the ranks in float32), the
# others 0.7e-6-5.9e-6; 0.0 against the unsplit port for the float64 MoE
# pair, whose float32 norms round the split sums' float64 differences
# away
TOL = 1e-5
# ... but the MoE pair against the reference: its bf16 dispatch flips
# roundings in float64 too (an expert's input rounded to bf16), so the
# port is as far from the reference as the reference's own (2, 2) and
# (1, 4) runs are from each other (mixtral-8x22b's caches: 4.1e-5 from the
# port, 4.5e-5 between the reference's meshes); held at the bar
# test_torch_lm_serve.py holds the unsplit port to the reference
TOL_MOE_REF = 1e-4
# rank 0's counted cells on (2, 2), a reduced config each: its prefill
# and its decode step at the dryrun's shapes (test_torch_lm_dryrun)
COUNTED = ("qwen2-0.5b", "gemma3-1b", "rwkv6-3b", "zamba2-7b",
           "whisper-base")
COUNTED_SHAPES = {"prefill": (PROMPT, BATCH), "decode": (PROMPT + 4, BATCH)}
# the subprocesses' bound (~60-90 s alone)
BOUND_S = 300


def cache_len(cfg) -> int:
    return cfg.num_prefix_embeds + PROMPT + STEPS


def counted_case(mode: str):
    from repro_torch.launch.specs import ShapeCase
    seq, batch = COUNTED_SHAPES[mode]
    return ShapeCase(f"mesh_serve_{mode}", seq, batch, mode)


# ---------------------------------------------------------------------------
# the reference: the JAX package on 4 forced host devices, which makes the
# inputs first


def _inputs(tmp: Path) -> None:
    from test_torch_lm_serve import case_configs, ref_tree

    from repro.models.transformer import TransformerLM as RefLM
    from repro_torch.models.conditioning import GRAD_CONDITIONED
    from repro_torch.models.convert import _flatten

    for arch in ARCHS:
        cfg, ref_cfg = case_configs(arch)
        tree = ref_tree(RefLM(ref_cfg), 0, arch in GRAD_CONDITIONED)
        np.savez(tmp / f"params_{arch}.npz", **_flatten(tree))
        rng = np.random.default_rng(5)
        out = {"tokens": rng.integers(1, cfg.vocab_size, (BATCH, PROMPT)),
               "forced": rng.integers(1, cfg.vocab_size, (BATCH, STEPS))}
        if cfg.encoder_layers:
            out["frames"] = rng.standard_normal(
                (BATCH, FRAMES, cfg.d_model)).astype(np.float32)
        if cfg.num_prefix_embeds:
            out["patches"] = rng.standard_normal(
                (BATCH, cfg.num_prefix_embeds, cfg.d_model)).astype(
                    np.float32)
        np.savez(tmp / f"batch_{arch}.npz", **out)
    (tmp / "inputs_ready").write_text("ok")


def load_batch(tmp: Path, arch: str) -> tuple[dict, np.ndarray]:
    """(the prompt batch, the teacher-forced tokens (BATCH, STEPS))."""
    data = dict(np.load(tmp / f"batch_{arch}.npz"))
    return data, data.pop("forced")


def _reference(tmp: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.models.transformer import TransformerLM
    from repro.sharding.rules import (ShardingRules, param_shardings,
                                      resolve_pspec, tree_shardings)
    from repro_torch.models.conditioning import FLOAT64

    assert len(jax.devices()) == WORLD
    _inputs(tmp)
    rules = ShardingRules.default()
    axes = {"tokens": ("batch", "seq"), "frames": ("batch", None, None),
            "patches": ("batch", None, None)}
    res = {}
    for arch in ARCHS:
        cut = ({"dtype": "float64", "cache_dtype": "float64"}
               if arch in FLOAT64 else {})
        with jax.enable_x64(arch in FLOAT64):
            model = TransformerLM(get_config(arch).reduced(**cut))
            params = jax.tree.map(jnp.asarray, load_params(
                tmp, arch, model.param_specs()))
            batch, forced = load_batch(tmp, arch)
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            n = cache_len(model.cfg)
            for mname, shape in MESHES.items():
                mesh = Mesh(np.asarray(jax.devices()).reshape(shape),
                            ("data", "model"))
                p_sh = param_shardings(model.param_specs(), rules, mesh)
                b_sh = {k: NamedSharding(mesh, resolve_pspec(
                    tuple(v.shape), axes[k], rules, mesh))
                    for k, v in batch.items()}
                prefill = jax.jit(
                    lambda p, b: model.prefill(p, b, cache_len=n),
                    in_shardings=(p_sh, b_sh))
                logits, caches = prefill(params, batch)
                key = f"{arch}/{mname}"
                res[f"{key}/logits_0"] = np.asarray(logits)
                for i, c in enumerate(jax.tree.leaves(caches)):
                    res[f"{key}/prefill_cache_{i}"] = np.asarray(c)
                tok_sh = NamedSharding(mesh, resolve_pspec(
                    (BATCH, 1), ("cache_batch", None), rules, mesh))
                c_sh = tree_shardings(caches, model.cache_axes(), rules,
                                      mesh)
                decode = jax.jit(model.decode_step, in_shardings=(
                    p_sh, c_sh, tok_sh, NamedSharding(mesh, P())))
                for t in range(STEPS):
                    # the caches as a jitted step's committed output: put
                    # on the shardings the next step takes
                    logits, caches = decode(
                        params, jax.device_put(caches, c_sh),
                        jnp.asarray(forced[:, t:t + 1]),
                        jnp.asarray(n - STEPS + t))
                    res[f"{key}/logits_{t + 1}"] = np.asarray(logits)
                for i, c in enumerate(jax.tree.leaves(caches)):
                    res[f"{key}/cache_{i}"] = np.asarray(c)
    np.savez(tmp / "ref.npz", **res)


# ---------------------------------------------------------------------------
# the port: 4 gloo ranks


def port_config(arch: str):
    """The reduced config, in float64 for the MoE pair (FLOAT64)."""
    from repro_torch.configs import get_config
    from repro_torch.models.conditioning import FLOAT64
    cut = ({"dtype": "float64", "cache_dtype": "float64"}
           if arch in FLOAT64 else {})
    return get_config(arch).reduced(**cut)


def port_model(tmp: Path, arch: str, mesh=None, cfg=None):
    """The port's model of ``arch`` with the reference's parameters, split
    over ``mesh``'s "model" dim (the default rules) when given."""
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding.rules import ShardingRules
    model = TransformerLM(cfg or port_config(arch), device="cpu")
    if mesh is not None:
        model.split_over_model(mesh, ShardingRules.default())
    return params_from_reference(load_params(tmp, arch, model.param_specs()),
                                 model)


def serve(model, batch: dict, forced: np.ndarray) -> dict:
    """Prefill of ``batch`` with decode headroom, `STEPS` teacher-forced
    decode steps, then `ServeEngine.generate`'s `NEW` tokens: the logits
    (``logits_<t>``), every cache leaf after prefill and after the last
    step, and the tokens."""
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_leaves
    n = cache_len(model.cfg)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    with torch.inference_mode():
        logits, caches = model.prefill(batch, cache_len=n)
        out["logits_0"] = logits.numpy()
        out.update((f"prefill_cache_{i}", c.numpy().copy())
                   for i, c in enumerate(tree_leaves(caches)))
        for t in range(STEPS):
            logits, caches = model.decode_step(
                caches, torch.from_numpy(forced[:, t:t + 1]), n - STEPS + t)
            out[f"logits_{t + 1}"] = logits.numpy()
        out.update((f"cache_{i}", c.numpy())
                   for i, c in enumerate(tree_leaves(caches)))
    out["tokens"] = ServeEngine(model).generate(batch, NEW).numpy()
    return out


def counted_cells(tmp: Path, arch: str, mesh) -> dict:
    """Rank 0's counts of the prefill and decode cells of `COUNTED_SHAPES`
    as `launch/dryrun.py` builds them (prefill's larger attention tiles,
    `input_specs`' zero inputs at a rank's rows, the split model's
    `init_cache` at the last position): FLOPs and the operand bytes of the
    all_reduces over "model"."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.specs import input_specs
    rows = BATCH // mesh.size(0)
    out = {}
    for mode in COUNTED_SHAPES:
        case = dataclasses.replace(counted_case(mode), global_batch=rows)
        cfg = port_config(arch)
        if mode == "prefill":
            cfg = dataclasses.replace(cfg, attn_q_chunk=4096,
                                      attn_kv_chunk=2048)
        model = port_model(tmp, arch, mesh, cfg)
        counts = model.tp.counts
        with torch.inference_mode():
            if mode == "prefill":
                args = (input_specs(cfg, case, "cpu"),)
                step = model.prefill
            else:
                args = (model.init_cache(rows, case.seq_len),
                        torch.zeros((rows, 1), dtype=torch.int32),
                        case.seq_len - 1)
                step = model.decode_step
            before = counts["all-reduce"]
            with FlopCounterMode(display=False) as fc:
                step(*args)
        out[mode] = {"flops": fc.get_total_flops(),
                     "model_all_reduce": counts["all-reduce"] - before}
    return out


def _worker(rank: int, tmp: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    _wait_for(tmp / "inputs_ready", BOUND_S)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=60))
    try:
        res, info = {}, {"coords": {}, "counts": {}}
        for mname, shape in MESHES.items():
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            di = mesh.get_coordinate()[0]
            info["coords"][mname] = mesh.get_coordinate()
            rows = slice(di * BATCH // shape[0], (di + 1) * BATCH // shape[0])
            for arch in ARCHS:
                batch, forced = load_batch(tmp, arch)
                out = serve(port_model(tmp, arch, mesh),
                            {k: v[rows] for k, v in batch.items()},
                            forced[rows])
                res.update((f"{arch}/{mname}/{k}", v) for k, v in out.items())
            if mname == "22":
                for arch in COUNTED:
                    counts = counted_cells(tmp, arch, mesh)
                    if rank == 0:
                        info["counts"][arch] = counts
        np.savez(tmp / f"port_{rank}.npz", **res)
        (tmp / f"port_{rank}.json").write_text(json.dumps(info))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the module's one run of both sides


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    # once per session: under xdist the workers share the session's base
    # directory, and the first to take the lock runs both sides for all
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    tmp = base / "torch_mesh_serve"
    with open(base / "torch_mesh_serve.lock", "w") as lock:
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
    return {"ref": dict(np.load(tmp / "ref.npz")),
            "ports": [dict(np.load(tmp / f"port_{r}.npz"))
                      for r in range(WORLD)],
            "infos": [json.loads((tmp / f"port_{r}.json").read_text())
                      for r in range(WORLD)],
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
                                        f"count={WORLD}"})]
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


@pytest.fixture(scope="module")
def unsplit(serve_runs):
    """The unsplit port's `serve` of every config, the whole batch."""
    tmp = serve_runs["tmp"]
    torch.set_num_threads(1)
    return {arch: serve(port_model(tmp, arch), *load_batch(tmp, arch))
            for arch in ARCHS}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def ref_tol(arch: str) -> float:
    from repro_torch.models.conditioning import FLOAT64
    return TOL_MOE_REF if arch in FLOAT64 else TOL


def rank_blocks(arch: str, mname: str, rank: int) -> tuple[slice, list]:
    """(this rank's batch rows, each cache leaf's (batch dim, `cache_split`
    leaf)): the split computed on the meta device at the rank's
    coordinate of a `ShapeMesh`."""
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.tree import flatten_up_to, tree_flatten, tree_leaves
    shape = MESHES[mname]
    mesh = ShapeMesh(shape, ("data", "model")).at(rank)
    model = TransformerLM(port_config(arch), device="meta")
    model.split_over_model(mesh, ShardingRules.default())
    caches = model.init_cache(1, 1)
    _, tdef = tree_flatten(caches)
    hows = flatten_up_to(tdef, model.cache_split())
    stacked = len(tree_leaves(caches["blocks"]))
    di = mesh.get_coordinate()[0]
    rows = slice(di * BATCH // shape[0], (di + 1) * BATCH // shape[0])
    return rows, [(int(i < stacked), how) for i, how in enumerate(hows)]


def cut_cache(whole: np.ndarray, rows: slice, bdim: int, how) -> np.ndarray:
    from repro_torch.models.transformer import cache_block
    block = cache_block(torch.from_numpy(np.ascontiguousarray(whole)), how)
    return np.take(block.numpy(), np.arange(BATCH)[rows], axis=bdim)


CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{MESHES[m][0]}x{MESHES[m][1]}" for a, m in CASES]


def port_of(serve_runs, arch: str, mname: str, rank: int) -> dict:
    prefix = f"{arch}/{mname}/"
    return {k[len(prefix):]: v for k, v in serve_runs["ports"][rank].items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("arch,mname", CASES, ids=IDS)
def test_split_logits_match_the_reference(serve_runs, unsplit, arch, mname):
    """Each rank's prefill logits and its 4 decode steps' logits, its rows'
    block of the vocabulary, against the reference's sharded prefill and
    decode_step and the unsplit port; the blocks of the ranks of "model"
    make the whole vocabulary."""
    ref, whole = serve_runs["ref"], unsplit[arch]
    for rank in range(WORLD):
        got = port_of(serve_runs, arch, mname, rank)
        rows, _ = rank_blocks(arch, mname, rank)
        m, size = rank % MESHES[mname][1], MESHES[mname][1]
        for t in range(STEPS + 1):
            k = f"logits_{t}"
            v = got[k].shape[-1]
            assert v * size == whole[k].shape[-1], k
            cols = slice(m * v, (m + 1) * v)
            want = ref[f"{arch}/{mname}/{k}"][rows, ..., cols]
            assert got[k].shape == want.shape, k
            assert rel(got[k], want) < ref_tol(arch), (rank, k)
            assert rel(got[k], whole[k][rows, ..., cols]) < TOL, (
                rank, k)


@pytest.mark.parametrize("arch,mname", CASES, ids=IDS)
def test_split_caches_match_the_reference(serve_runs, unsplit, arch, mname):
    """Each rank's cache leaves after prefill and after the last decode
    step: its rows and its `cache_split` block (the kv heads it computes;
    mamba2's d_inner block and heads; rwkv6's heads) of the reference's
    and of the unsplit port's."""
    ref, whole = serve_runs["ref"], unsplit[arch]
    split_somewhere = False
    for rank in range(WORLD):
        got = port_of(serve_runs, arch, mname, rank)
        rows, leaves = rank_blocks(arch, mname, rank)
        split_somewhere |= any(how is not None for _, how in leaves)
        for stage in ("prefill_cache", "cache"):
            assert not any(f"{stage}_{len(leaves)}" == k for k in got)
            for i, (bdim, how) in enumerate(leaves):
                k = f"{stage}_{i}"
                want = cut_cache(ref[f"{arch}/{mname}/{k}"], rows, bdim, how)
                assert got[k].shape == want.shape, (rank, k)
                assert rel(got[k], want) < ref_tol(arch), (
                    rank, k)
                assert rel(got[k], cut_cache(whole[k], rows, bdim,
                                             how)) < TOL, (rank, k)
    assert split_somewhere


@pytest.mark.parametrize("arch,mname", CASES, ids=IDS)
def test_split_engine_tokens_equal_the_unsplit_engine(serve_runs, unsplit,
                                                      arch, mname):
    """`ServeEngine.generate` on the split model: every rank of "model"
    takes the same tokens for its rows, and the rows of the data ranks
    make the unsplit engine's tokens."""
    want = unsplit[arch]["tokens"]
    for rank in range(WORLD):
        rows, _ = rank_blocks(arch, mname, rank)
        got = port_of(serve_runs, arch, mname, rank)["tokens"]
        assert np.array_equal(got, want[rows]), rank


def test_ranks_sit_on_the_meshes_and_split_every_config(serve_runs):
    """Rank r's coordinate on (2, 2) is (r // 2, r % 2) and on (1, 4) (0,
    r), as `ShapeMesh.at(r)` puts it, and every config's logits are a
    block of the vocabulary (the reduced 512 splits 2 and 4 ways)."""
    for r, info in enumerate(serve_runs["infos"]):
        assert info["coords"] == {"22": [r // 2, r % 2], "14": [0, r]}
        for arch in ARCHS:
            for mname, shape in MESHES.items():
                v = port_of(serve_runs, arch, mname, r)["logits_0"].shape[-1]
                assert v == port_config(arch).vocab_size // shape[1]


if __name__ == "__main__":
    role, *args = sys.argv[1:]
    if role == "reference":
        _reference(Path(args[0]))
    else:
        assert role == "worker"
        _worker(int(args[0]), Path(args[1]))
