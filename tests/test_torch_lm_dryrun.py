"""The port's LM dryrun (`repro_torch.launch.dryrun`, `.sweep`) against the
JAX package's shardings, and its meta-device counters against the same
step run for real.

* Memory: for every arch x shape x production mesh, the bytes a device
  holds of parameters, optimizer state, caches and inputs equal those
  worked out from the reference's ``NamedSharding.shard_shape`` over
  ``jax.sharding.AbstractMesh`` (16, 16) and (2, 16, 16), with the
  reference's ``state_shardings``, ``param_shardings`` and
  ``tree_shardings``. ``repro.launch.dryrun`` is not imported (it forces
  512 host devices when imported), so its ``pick_optimizer`` and
  ``BATCH_AXES`` are restated here.
* Cost: the meta step's ``flops`` and ``bytes_accessed`` equal the same
  counters around the same step run on the CPU, reduced configs of each
  family, in each mode; ``model_flops`` is the reference's formula
  (``benchmarks/roofline.py``, restated).
* Tensor parallelism over "model": every cell records ``"model_axis":
  "tensor"``; a reduced config's train cell on a (2, 2) `ShapeMesh`
  (qwen2-0.5b, gemma3-1b, zamba2-7b, whisper-base) has the FLOPs and the
  operand bytes of the all_reduces over "model" that rank 0's step on 4
  gloo ranks recorded (`test_torch_mesh_train`'s run, shared through its
  ``runs`` fixture), and a reduced config's prefill and decode cells
  those of rank 0's prefill and decode step (`test_torch_mesh_serve`'s
  ``serve_runs``); qwen2-0.5b's train_4k on (16, 16) counts its d_ff and
  vocabulary products at 1/16, and rwkv6-3b's splits its channel mix
  and vocabulary and not its time mix; a decode cell gives the port's
  cache bytes a rank where they differ from the rules' block.
* `run_cell` at full width, one cell a mode; the sweep's resume, its
  contained failures and its exit code; `card_check` refuses to run
  without a card.
"""

import dataclasses
import json
import math
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.models.transformer import TransformerLM as RefLM
from repro.sharding import rules as ref_rules
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro.train.trainer import state_shardings as ref_state_shardings

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, sweep
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.launch.specs import SHAPES, ShapeCase, cell_runnable
from test_torch_mesh_serve import COUNTED as SERVE_COUNTED
from test_torch_mesh_serve import (COUNTED_SHAPES, counted_case, port_config,
                                   serve_runs)
from test_torch_mesh_train import BATCH, COUNTED, SEQ, _port_config, runs

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(m, a, s) for m in MESHES for a in ARCHS for s in SHAPES
         if cell_runnable(get_config(a), s)[0]]
# repro/launch/dryrun.py:45-50
REF_BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                  "frames": ("batch", None, None),
                  "patches": ("batch", None, None)}


def ref_pick_optimizer(cfg) -> str:
    """repro/launch/dryrun.py:61-63."""
    return "adafactor" if cfg.n_params() > 20e9 else "adamw"


def shard_bytes(tree, shardings) -> int:
    """One device's bytes of an abstract tree: the reference's shard shapes
    (every split is even, so every device holds the same)."""
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
               for x, sh in zip(leaves, shs))


def ref_memory(mesh_name: str, arch: str, shape: str) -> dict:
    """Bytes a device of the reference's cell, by kind, as the port's
    record names them."""
    mesh = AbstractMesh(*MESHES[mesh_name])
    rules = ref_rules.ShardingRules.default(multi_pod=mesh_name == "multi_pod")
    cfg = ref_get_config(arch)
    model = RefLM(cfg)
    case = ref_specs.SHAPES[shape]
    inputs = ref_specs.input_specs(cfg, shape)
    out = {}
    if case.mode == "train":
        params = ref_rules.abstract_params(model.param_specs())
        opt, _ = ref_make_train_step(
            model, RefTrainerConfig(optimizer=ref_pick_optimizer(cfg)))
        state = {"params": params, "opt_state": jax.eval_shape(opt.init,
                                                               params),
                 "step": jax.ShapeDtypeStruct((), jax.numpy.int32)}
        sh = ref_state_shardings(model, state, rules, mesh)
        for k in state:
            out[f"{k}_bytes"] = shard_bytes(state[k], sh[k])
    else:
        params = ref_rules.abstract_params(model.param_specs(),
                                           dtype="bfloat16")
        out["params_bytes"] = shard_bytes(params, ref_rules.param_shardings(
            model.param_specs(), rules, mesh))
    if case.mode == "decode":
        caches, token, _ = inputs
        out["caches_bytes"] = shard_bytes(caches, ref_rules.tree_shardings(
            caches, model.cache_axes(), rules, mesh))
        inputs = {"tokens": token}
        axes = {"tokens": ("cache_batch", None)}
    else:
        axes = REF_BATCH_AXES
    out["inputs_bytes"] = shard_bytes(inputs, {
        k: NamedSharding(mesh, P(*ref_rules.resolve_pspec(
            tuple(v.shape), axes[k], rules, mesh)))
        for k, v in inputs.items()})
    return out


@pytest.mark.parametrize("mesh,arch,shape", CELLS)
def test_memory_per_device_is_the_references(mesh, arch, shape):
    cell = dryrun.build_cell(arch, shape, mesh)
    mem = dryrun.cell_memory(cell)
    want = ref_memory(mesh, arch, shape)
    got = {k: v for k, v in mem.items() if k in want}
    assert got == want
    assert mem["total_bytes"] == sum(want.values())
    assert mem["per_rank"] == {"min": mem["total_bytes"],
                               "max": mem["total_bytes"]}
    if SHAPES[shape].mode == "train":
        assert cell.optimizer == ref_pick_optimizer(get_config(arch))


# ---------------------------------------------------------------------------
# the meta step's counters against the step run on the CPU

FAMILIES = ["qwen2-0.5b", "gemma3-1b", "mixtral-8x22b", "rwkv6-3b",
            "zamba2-7b", "whisper-base", "internvl2-2b"]
TINY = {"train": ShapeCase("tiny_train", 48, 2, "train"),
        "prefill": ShapeCase("tiny_prefill", 48, 2, "prefill"),
        "decode": ShapeCase("tiny_decode", 48, 2, "decode")}


def counters(arch, case, device, mesh="one_card", grad_accum=1):
    cfg = get_config(arch).reduced()
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    cell = dryrun.build_cell(arch, case, mesh, cfg=cfg, device=device,
                             generator=gen, grad_accum=grad_accum)
    cost = dryrun.cell_cost(cell)
    return cell, cost["flops"], cost["bytes_accessed"]


@pytest.mark.parametrize("mode", list(TINY))
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_counters_equal_the_cpu_step(arch, mode):
    _, flops, nbytes = counters(arch, TINY[mode], "meta")
    cell, cpu_flops, cpu_bytes = counters(arch, TINY[mode], "cpu")
    assert cell.model.device.type == "cpu"
    assert flops > 0 and nbytes > 0
    assert (flops, nbytes) == (cpu_flops, cpu_bytes)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_meta_counters_at_one_ranks_rows(grad_accum):
    """A batch of 32 on (16, 16): each rank computes 2 rows, on meta as on
    the CPU; microbatches lead and stay whole."""
    case = ShapeCase("tiny_train", 48, 32, "train")
    cell, flops, nbytes = counters("qwen2-0.5b", case, "meta", "single_pod",
                                   grad_accum)
    rows = 2 // grad_accum
    assert cell.rows == rows
    lead = (grad_accum,) if grad_accum > 1 else ()
    assert cell.local_inputs()["tokens"].shape == lead + (rows, 48)
    _, cpu_flops, cpu_bytes = counters("qwen2-0.5b", case, "cpu",
                                       "single_pod", grad_accum)
    assert (flops, nbytes) == (cpu_flops, cpu_bytes)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_is_the_references_formula(arch, shape):
    """benchmarks/roofline.py:38-50: 6ND train, 2ND prefill, 2NB decode over
    the chips, N the active parameters."""
    cfg, case = ref_get_config(arch), ref_specs.SHAPES[shape]
    n = cfg.n_active_params()
    if case.mode == "train":
        total = 6.0 * n * case.global_batch * case.seq_len
    elif case.mode == "prefill":
        total = 2.0 * n * case.global_batch * case.seq_len
    else:
        total = 2.0 * n * case.global_batch
    for chips in (1, 256, 512):
        assert dryrun.model_flops(get_config(arch), SHAPES[shape],
                                  chips) == total / chips


def test_ring_bytes_are_the_references_multipliers():
    # repro/launch/hlo_analysis.py:6-12
    assert dryrun.ring_bytes("all-gather", 1024, 16) == 960
    assert dryrun.ring_bytes("reduce-scatter", 1024, 16) == 960
    assert dryrun.ring_bytes("all-reduce", 1024, 16) == 1920
    assert dryrun.ring_bytes("all-to-all", 1024, 4) == 768
    assert dryrun.ring_bytes("all-reduce", 1024, 1) == 0


# ---------------------------------------------------------------------------
# run_cell at full width


def check_record(rec, mesh):
    assert rec["ok"] and not rec.get("skipped"), rec.get("traceback")
    cost = rec["cost"]
    for k in ("flops", "bytes_accessed", "model_flops", "compute_s",
              "memory_s"):
        assert math.isfinite(cost[k]) and cost[k] > 0, k
    assert cost["model_axis"] == "tensor"
    assert (cost["model_all_reduce_bytes"] > 0) == (mesh != "one_card")
    assert cost["bytes_model"] == "unfused"
    assert cost["bound"] in ("compute_s", "memory_s", "collective_s")
    assert cost[cost["bound"]] == max(cost["compute_s"], cost["memory_s"],
                                      cost["collective_s"])
    assert set(cost["rates"]) == set(dryrun.RATES)
    assert rec["devices"] == math.prod(dryrun.MESHES[mesh][0])
    assert cost["collective_bytes"] == sum(cost["collectives"].values())
    assert (cost["collective_bytes"] > 0) == (mesh != "one_card")
    assert rec["memory"]["total_bytes"] > 0


@pytest.mark.parametrize("arch,optimizer", COUNTED)
def test_meta_cell_has_the_flops_and_model_bytes_of_rank0s_step(
        runs, arch, optimizer):
    """The reduced config's train cell on a (2, 2) ShapeMesh, 4 x 40
    tokens (whisper's train shape of 80 positions: 4 x 40 tokens and 4 x
    40 frames): the model at rank 0's blocks
    along "model", its step on meta has the FLOPs and the all_reduce
    operand bytes over "model" that rank 0's first tensor-parallel step
    on 4 gloo ranks counted (gemma3-1b's one kv head whole, qwen2-0.5b's
    two split; zamba2-7b's mamba blocks and shared attention block,
    whisper-base's encoder and cross attention)."""
    counts = runs["infos"][0]["counts"][f"{arch}-{optimizer}"]
    seq = 2 * SEQ if _port_config(arch).encoder_layers else SEQ
    cell = dryrun.build_cell(
        arch, ShapeCase("mesh_train", seq, BATCH, "train"),
        ShapeMesh((2, 2), ("data", "model")), cfg=_port_config(arch),
        optimizer=optimizer)
    assert cell.rows == BATCH // 2 and cell.model_axis == "tensor"
    cost = dryrun.cell_cost(cell)
    assert counts["flops"] > 0 and counts["model_all_reduce"] > 0
    assert cost["flops"] == counts["flops"]
    assert cost["model_all_reduce_bytes"] == counts["model_all_reduce"]


# the reduced configs whose rank-0 caches on (2, 2) are not the rules'
# block, and by how much: gemma3-1b's one kv head is whole under its split
# q heads, where the rules shard the caches' head_dim (cache_head_dim)
PORT_CACHE_RATIO = {"gemma3-1b": 2}


@pytest.mark.parametrize("mode", list(COUNTED_SHAPES))
@pytest.mark.parametrize("arch", SERVE_COUNTED)
def test_meta_serving_cell_has_the_flops_and_model_bytes_of_rank0s_step(
        serve_runs, arch, mode):
    """The reduced config's prefill cell (4 x 96 tokens; whisper's 4 x 48
    tokens and 4 x 48 frames) and decode cell (a cache of 100) on a (2, 2)
    ShapeMesh: the model at rank 0's blocks along "model", its step on
    meta has the FLOPs and the all_reduce operand bytes over "model" that
    rank 0's prefill and decode step on 4 gloo ranks counted (qwen2-0.5b's
    two kv heads split, gemma3-1b's one whole, rwkv6-3b's time mix,
    zamba2-7b's mamba blocks and shared block, whisper-base's encoder and
    cross attention); a decode cell's port cache bytes beside the rules'
    where they differ."""
    counts = serve_runs["infos"][0]["counts"][arch][mode]
    cell = dryrun.build_cell(arch, counted_case(mode),
                             ShapeMesh((2, 2), ("data", "model")),
                             cfg=port_config(arch))
    assert cell.rows == 2 and cell.model_axis == "tensor"
    cost = dryrun.cell_cost(cell)
    assert counts["flops"] > 0 and counts["model_all_reduce"] > 0
    assert cost["flops"] == counts["flops"]
    assert cost["model_all_reduce_bytes"] == counts["model_all_reduce"]
    mem = dryrun.cell_memory(cell)
    if mode == "decode" and arch in PORT_CACHE_RATIO:
        assert mem["port_caches_bytes"] == (PORT_CACHE_RATIO[arch]
                                            * mem["caches_bytes"])
    else:
        assert "port_caches_bytes" not in mem


def test_train_4k_counts_d_ff_and_vocab_products_at_a_sixteenth():
    """qwen2-0.5b's train_4k on (16, 16), at 2 of its 24 layers: its 14
    heads and 2 kv heads stay whole, its d_ff (4864) and vocabulary
    (151936) split 16 ways, so its step's FLOPs are those of the step
    with nothing split over "model" at d_ff / 16 and vocab / 16."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2)
    split = dryrun.build_cell("qwen2-0.5b", "train_4k", "single_pod",
                              cfg=cfg)
    none = dryrun.ShardingRules.default().with_overrides(
        heads=None, kv_heads=None, d_ff=None, vocab=None)
    whole = dryrun.build_cell(
        "qwen2-0.5b", "train_4k", "single_pod", rules=none,
        cfg=dataclasses.replace(cfg, d_ff=cfg.d_ff // 16,
                                vocab_size=cfg.vocab_size // 16))
    assert (split.model_axis, whole.model_axis) == ("tensor", "replicated")
    plan = split.model.split_plan
    assert plan["blocks"]["0"]["attn"]["wq"] == "whole"
    assert plan["blocks"]["0"]["mlp"]["wi"] == 2 and plan["embed"] == 0
    assert (dryrun.cell_cost(split)["flops"]
            == dryrun.cell_cost(whole)["flops"])


def test_rwkv6_train_4k_splits_the_channel_mix_and_vocab_not_the_time_mix():
    """rwkv6-3b's train_4k on (16, 16), at 2 of its 32 layers: its 40 heads
    do not divide over 16, so the time mix stays whole; its d_ff (8960)
    and vocabulary (65536) split 16 ways, so its step's FLOPs are those of
    the step with nothing split over "model" at d_ff / 16 and vocab /
    16."""
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=2)
    split = dryrun.build_cell("rwkv6-3b", "train_4k", "single_pod", cfg=cfg)
    plan = split.model.split_plan
    assert split.model_axis == "tensor"
    assert set(tree_leaves(plan["blocks"]["0"]["tmix"])) == {"whole"}
    assert plan["blocks"]["0"]["cmix"] == {"wk": 2, "wv": 1, "mu_k": "whole",
                                           "mu_r": "whole", "wr": "whole"}
    assert plan["embed"] == 0 and plan["lm_head"] == 1
    none = dryrun.ShardingRules.default().with_overrides(
        heads=None, kv_heads=None, d_ff=None, vocab=None)
    whole = dryrun.build_cell(
        "rwkv6-3b", "train_4k", "single_pod", rules=none,
        cfg=dataclasses.replace(cfg, d_ff=cfg.d_ff // 16,
                                vocab_size=cfg.vocab_size // 16))
    assert whole.model_axis == "replicated"
    assert (dryrun.cell_cost(split)["flops"]
            == dryrun.cell_cost(whole)["flops"])


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen2-0.5b", "decode_32k", "single_pod"),
    ("whisper-base", "prefill_32k", "multi_pod"),
    ("whisper-base", "train_4k", "single_pod")])
def test_run_cell_at_full_width(arch, shape, mesh):
    rec = dryrun.run_cell(arch, shape, mesh)
    check_record(rec, mesh)
    cell = dryrun.build_cell(arch, shape, mesh)
    assert rec["memory"] == dryrun.cell_memory(cell)
    assert rec["cost"]["rows_per_device"] == cell.rows
    if SHAPES[shape].mode == "train":
        assert rec["optimizer"] == "adamw"
        coll = rec["cost"]["collectives"]
        assert coll["reduce-scatter"] > 0 and coll["all-gather"] > 0
    if shape == "decode_32k":
        # 128 sequences over 16 data ranks; qwen2-0.5b's 14 heads stay
        # whole over 16, so a rank holds its rows' whole cache, where the
        # rules shard its head_dim 16 ways (cache_head_dim)
        assert rec["cost"]["rows_per_device"] == 8
        mem = rec["memory"]
        assert mem["port_caches_bytes"] == 16 * mem["caches_bytes"]


def test_run_cell_skips_long_500k_for_full_attention():
    rec = dryrun.run_cell("qwen2-0.5b", "long_500k", "multi_pod")
    assert rec["ok"] and rec["skipped"]
    assert rec["reason"] == ref_specs.cell_runnable(
        ref_get_config("qwen2-0.5b"), "long_500k")[1]


def test_dryrun_cli_takes_rules_and_cfg_overrides(tmp_path, capsys):
    out = tmp_path / "rec.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                     "--mesh", "single_pod", "--rules", "cache_seq=model",
                     "cache_heads=", "--cfg", "cross_len=1504",
                     "--out", str(out)])
    assert e.value.code == 0
    rec = json.loads(out.read_text())
    assert rec == json.loads(capsys.readouterr().out)
    check_record(rec, "single_pod")
    rules = dryrun.ShardingRules.default().with_overrides(cache_seq="model",
                                                          cache_heads=None)
    cfg = dataclasses.replace(get_config("whisper-base"), cross_len=1504)
    cell = dryrun.build_cell("whisper-base", "decode_32k", "single_pod",
                             rules=rules, cfg=cfg)
    assert rec["memory"] == dryrun.cell_memory(cell)
    # the self and cross caches split over their positions on "model"
    for sh in dryrun.tree_leaves(cell.shardings["caches"]):
        assert sh.spec[2] == "model"


def test_card_check_needs_a_card(monkeypatch):
    rec = {"arch": "qwen2-0.5b", "shape": "decode_32k", "mesh": "one_card",
           "mode": "decode"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.card_check(rec)
    with pytest.raises(ValueError, match="on a card"):
        dryrun.card_check(rec, device="cpu")


# ---------------------------------------------------------------------------
# the sweep


def run_sweep(args, capsys, monkeypatch) -> tuple[int, str]:
    """`sweep.main` in this process (its cells are subprocesses, which find
    the package on PYTHONPATH): (exit code, standard output)."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        filter(None, [src, os.environ.get("PYTHONPATH")])))
    with pytest.raises(SystemExit) as e:
        sweep.main(args)
    return e.value.code, capsys.readouterr().out


def test_sweep_writes_records_and_reruns_a_corrupt_one(tmp_path, capsys,
                                                       monkeypatch):
    corrupt = tmp_path / "whisper-base__decode_32k__one_card.json"
    corrupt.write_text("{not json")
    code, out = run_sweep(["--out", str(tmp_path), "--archs", "whisper-base",
                           "--shapes", "decode_32k", "long_500k",
                           "--meshes", "one_card"], capsys, monkeypatch)
    assert code == 0, out
    lines = [ln for ln in out.splitlines() if ln.startswith("[")]
    assert [ln[:6] for ln in lines] == ["[ok  ]", "[SKIP]"]
    assert "2 cells, 0 failures" in out
    check_record(json.loads(corrupt.read_text()), "one_card")
    skipped = json.loads(
        (tmp_path / "whisper-base__long_500k__one_card.json").read_text())
    assert skipped["skipped"] and skipped["ok"]
    assert skipped["reason"] == ref_specs.cell_runnable(
        ref_get_config("whisper-base"), "long_500k")[1]


def test_sweep_reuses_a_record_without_a_subprocess(tmp_path, monkeypatch,
                                                    capsys):
    rec = {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "single_pod",
           "mode": "train", "ok": True}
    (tmp_path / "qwen2-0.5b__train_4k__single_pod.json").write_text(
        json.dumps(rec))

    def refuse(*a, **k):
        raise AssertionError("the sweep started a subprocess")
    monkeypatch.setattr(sweep.subprocess, "run", refuse)
    code, out = run_sweep(["--out", str(tmp_path), "--archs", "qwen2-0.5b",
                           "--shapes", "train_4k", "--meshes", "single_pod"],
                          capsys, monkeypatch)
    assert code == 0
    assert "[ok  ] single_pod" in out


def test_sweep_contains_a_timeout_and_exits_1(tmp_path, capsys,
                                              monkeypatch):
    code, out = run_sweep(["--out", str(tmp_path), "--archs", "qwen2-0.5b",
                           "--shapes", "train_4k", "--meshes", "single_pod",
                           "--timeout", "1"], capsys, monkeypatch)
    assert code == 1
    assert "[FAIL]" in out and "1 cells, 1 failures" in out
    rec = json.loads(
        (tmp_path / "qwen2-0.5b__train_4k__single_pod.json").read_text())
    assert rec["ok"] is False and rec["error"] == "timeout after 1s"
    assert rec["wall_s"] >= 1
