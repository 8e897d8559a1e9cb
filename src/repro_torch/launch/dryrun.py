"""The LM dryrun: one (arch x shape x mesh) cell's memory and cost per
device, worked out on the meta device, the counterpart of the JAX
package's ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh single_pod [--out rec.json] \\
        [--rules k=v ...] [--cfg k=v ...] [--optimizer adamw] \\
        [--grad-accum N]

It answers the reference's question, how much a cell takes of each
device of a 256-rank (16, 16) ``("data", "model")`` or a 512-rank
(2, 16, 16) ``("pod", "data", "model")`` mesh, without a card or a
process group: the mesh is a `ShapeMesh` (``--mesh one_card`` is a
(1, 1) mesh, one card). `build_cell` builds the cell at full width and
depth on ``torch.device("meta")``: the train state ``{"params",
"opt_state", "step"}`` (float32 parameters, the optimizer of
`make_train_step`; adafactor above 20e9 parameters, else adamw), or
bfloat16 parameters for prefill and decode, and the inputs of
`specs.input_specs`. The record holds:

  memory  the bytes of parameters, optimizer state, caches and inputs on
          the largest device, each leaf's block from the port's
          shardings (`state_shardings`, `param_shardings`,
          `tree_shardings` over `cache_axes`, the batch rule of
          `BATCH_AXES`) and `local_slices`; ``per_rank`` the least and
          the most of every rank's total; a decode cell whose caches the
          port holds otherwise than the rules' blocks (kv heads whole
          under split q heads, heads whole, the rules' ``cache_head_dim``
          fallback) adds ``port_caches_bytes``, rank 0's
          (`TransformerLM.cache_split`)
  cost    the step run on meta at the rows one rank holds under the batch
          rule, as rank 0 computes it (``model_axis``): the model holds
          rank 0's blocks of the leaves the rules split over "model"
          (heads, kv_heads, d_ff, ssm_heads, vocab;
          `TransformerLM.model_split`) and computes its blocks of the
          products ("tensor"; "replicated" where the rules split none),
          in a decode step at its blocks of the caches. ``flops``
          counted by ``FlopCounterMode``,
          ``bytes_accessed`` every op's input and output tensor bytes
          (`ByteCounter`, an unfused upper bound); ``model_flops`` the
          reference's 6ND / 2ND / 2NB over the chips;
          ``collective_bytes`` the collectives the port's step issues on
          the mesh (the parameter gather over the mesh dims other than
          "model" for the leaves the model holds split, over every dim
          for the others; train: `_DataParallel`'s gradient reduction
          too; and the model's all_reduces over "model", counted where
          the step issues them, ``model_all_reduce_bytes`` their
          operands) at the ring multipliers of the reference's
          ``hlo_analysis.py``;
          ``compute_s``, ``memory_s`` and ``collective_s`` at the H100
          rates of `RATES`, and ``bound`` the largest

What of the reference does not port, and why:

- its first lines force 512 host devices through ``XLA_FLAGS``: there
  are no devices to force, and no process group is made;
- ``cost_scanned``, ``_extrapolated_cost``, ``set_unroll`` and
  ``--skip-cost``: XLA's cost analysis counts a while loop's body once,
  so the reference measures unrolled shallow variants and extrapolates
  in depth. Here the step runs every layer on meta and every op is
  counted; the port's ``maybe_scan`` is a Python loop with no unroll
  switch (`repro_torch.models.scanning`);
- ``launch/hlo_analysis.py`` and ``launch/bytes_pass.py`` parse XLA's
  optimized HLO text and ``cost_analysis()``: PyTorch compiles no such
  program. The ring multipliers are copied into `ring_bytes`;
- ``compat.py`` papers over differences between JAX versions
  (``shard_map``, ``make_mesh``); torch has ``init_device_mesh`` and
  explicit collectives.

`card_check` builds a one_card cell on the card and holds it to its
record: the bytes of the tensors, the allocator's count, and the FLOPs of
the step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from collections import Counter
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.fft.spec import resolve_device
from repro_torch.launch.fft_dryrun import HBM_BYTES_S, NET_BYTES_S
from repro_torch.launch.mesh import MESHES, ShapeMesh
from repro_torch.launch.specs import (SHAPES, ShapeCase, cell_runnable,
                                      input_specs)
from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding.rules import (NamedSharding, ShardingRules,
                                        abstract_params, local_slices,
                                        param_shardings, resolve_pspec,
                                        tree_shardings)
from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                       make_train_step, state_shardings)
from repro_torch.tree import tree_leaves

BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", None, None),
    "patches": ("batch", None, None),
}

# the rates of the three terms, each named in the record
RATES = {
    # NVIDIA H100 SXM datasheet, dense bf16 on the tensor cores (PERF.md §3)
    "flops_s": {"value": 989.4e12, "name": "H100 SXM dense bf16"},
    "hbm_bytes_s": {"value": HBM_BYTES_S, "name": "H100 SXM HBM3"},
    # a card's link out of its node, as `fft_dryrun` prices its exchanges:
    # a 256- or 512-rank mesh spans 32 or 64 eight-card nodes (the tuner's
    # CUDA `ici_bps` is a copy on one card, no link)
    "net_bytes_s": {"value": NET_BYTES_S,
                    "name": "fft_dryrun.NET_BYTES_S, 400 Gb/s NDR a card"},
}


def pick_optimizer(cfg) -> str:
    """Adafactor for >20B-param configs (halves optimizer HBM), else adamw."""
    return "adafactor" if cfg.n_params() > 20e9 else "adamw"


def ring_bytes(kind: str, nbytes: float, n: int) -> float:
    """One device's bytes for a collective over a group of ``n``, with the
    reference's ring multipliers (``launch/hlo_analysis.py``): ``nbytes``
    is the gathered result of an all-gather, else the operand."""
    frac = (n - 1) / n
    return {"all-gather": frac, "reduce-scatter": frac,
            "all-reduce": 2.0 * frac, "all-to-all": frac}[kind] * nbytes


_ATEN = torch.ops.aten
_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


def _from_host(func, args, out) -> bool:
    """Is this op a copy from host memory onto another device (a table
    numpy made)? The CPU runs no such op, and it moves no device bytes."""
    if func is _ATEN._to_copy.default:
        src, dst = args[0], out
    elif func is _ATEN.copy_.default:
        dst, src = args[0], args[1]
    else:
        return False
    return src.device.type == "cpu" and dst.device.type != "cpu"


class ByteCounter(TorchDispatchMode):
    """The bytes of every op's tensor inputs and outputs, added up: what an
    unfused run moves at most. An op that reaches the mode whole but is
    made of others (``einsum`` under inference mode) is counted as the
    ops it runs (its permuted copies too); views move nothing, nor does a
    copy from the host (`_from_host`) move device bytes: neither is
    counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.has_kernel_for_dispatch_key(_COMPOSITE):
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if not (func.is_view or _from_host(func, args, out)):
            self.bytes += sum(x.numel() * x.element_size() for x in
                              pytree_leaves((args, kwargs, out))
                              if isinstance(x, torch.Tensor))
        return out


def tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def allocator_rounding(tree) -> int:
    """The most the CUDA caching allocator may count beyond the tensors of
    ``tree``: each block is a multiple of 512 bytes, and a block of its
    large pool (over 1 MiB) is handed out whole when the rest would be 1
    MiB or less."""
    out = 0
    for x in tree_leaves(tree):
        n = x.numel() * x.element_size()
        out += -n % 512 + ((1 << 20) if n > (1 << 20) else 0)
    return out


@dataclass
class Cell:
    """One cell built: the model, its global inputs and state, and the
    shardings of each, by kind ("params", "opt_state", "step", "caches",
    "inputs"). A train cell's ``step_state`` is the state rank 0's step
    updates: ``tensors``' own, or where the model holds blocks along
    "model", its parameters and their optimizer state."""
    case: ShapeCase
    mesh: ShapeMesh
    cfg: object
    model: TransformerLM
    tensors: dict        # kind -> tree of tensors
    shardings: dict      # kind -> tree of NamedSharding, the same nesting
    optimizer: str | None = None
    grad_accum: int = 1
    step_fn: object = None
    step_state: dict | None = None

    @property
    def model_axis(self) -> str:
        """"tensor" where the step computes split over "model", else
        "replicated"."""
        return "tensor" if self.model.tp is not None else "replicated"

    @property
    def mode(self) -> str:
        return self.case.mode

    @property
    def rows(self) -> int:
        """The batch rows one rank holds (and computes): a microbatch's
        under accumulation, whose microbatches lead."""
        tokens = self.tensors["inputs"]["tokens"]
        bdim = 1 if self.grad_accum > 1 else 0
        block = local_slices(tuple(tokens.shape), self.mesh.at(0),
                             self.shardings["inputs"]["tokens"].placements)
        return block[bdim].stop - block[bdim].start

    def local_inputs(self):
        """One rank's inputs: the cell's own when a rank holds every row
        and all of the caches; a decode step's caches at the model's
        blocks (`init_cache`) where it is split over "model"."""
        t, case = self.tensors, self.case
        split = self.model.tp is not None and self.model.tp.size > 1
        if self.rows * self.grad_accum == case.global_batch and not split:
            if self.mode == "decode":  # at input_specs' position
                return t["caches"], t["inputs"]["tokens"], case.seq_len - 1
            return t["inputs"]
        local = dataclasses.replace(
            case, global_batch=self.rows * self.grad_accum)
        device = t["inputs"]["tokens"].device
        if self.mode == "decode":
            return (self.model.init_cache(self.rows, case.seq_len),
                    torch.zeros((self.rows, 1), dtype=torch.int32,
                                device=device), case.seq_len - 1)
        return _microbatched(input_specs(self.cfg, local, device),
                             self.grad_accum)

    def step(self, args):
        """The cell's step on ``args`` (`local_inputs`)."""
        if self.mode == "train":
            return self.step_fn(self.step_state, args)
        with torch.inference_mode():
            if self.mode == "prefill":
                return self.model.prefill(args)
            return self.model.decode_step(*args)


def _microbatched(batch: dict, accum: int) -> dict:
    """(accum, B / accum, ...) leaves for gradient accumulation."""
    if accum == 1:
        return batch
    return {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def build_cell(arch: str, shape, mesh_name: str = "one_card", *,
               rules: ShardingRules | None = None,
               optimizer: str | None = None, cfg=None, grad_accum: int = 1,
               device="meta", generator: torch.Generator | None = None
               ) -> Cell:
    """The cell's model, state or bf16 parameters, inputs and shardings on
    ``device`` (meta: shapes only). ``shape`` is a name of `SHAPES` or a
    `ShapeCase`; ``mesh_name`` a name of `MESHES` or a `ShapeMesh`;
    ``cfg`` replaces the arch's config (overrides, a reduced config);
    ``generator`` draws the parameters on a real device. The model is
    split over "model" as rank 0's (`split_over_model`); ``tensors`` stay
    the global state or parameters, on meta where the model holds
    blocks."""
    case = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = (mesh_name if isinstance(mesh_name, ShapeMesh)
            else ShapeMesh(*MESHES[mesh_name]))
    rules = rules or ShardingRules.default(
        multi_pod="pod" in mesh.mesh_dim_names)
    cfg = cfg or get_config(arch)
    if case.mode == "prefill":
        # prefill has no backward: larger tiles bound the q-chunk loop at
        # 32k without a remat-memory cost (the reference's override)
        cfg = dataclasses.replace(cfg, attn_q_chunk=4096, attn_kv_chunk=2048)
    model = TransformerLM(cfg, device=device, generator=generator)
    inputs = input_specs(cfg, case, device)

    if case.mode == "train":
        batch = _microbatched(inputs, grad_accum)
        lead = (None,) if grad_accum > 1 else ()
        tc = TrainerConfig(optimizer=optimizer or pick_optimizer(cfg),
                           grad_accum=grad_accum)
        opt, step_fn = make_train_step(model, tc)

        def fresh(params):
            return {"params": params, "opt_state": opt.init(params),
                    "step": torch.zeros((), dtype=torch.int32,
                                        device=params["embed"].device)}
        model.split_over_model(mesh.at(0), rules)
        state = step_state = fresh(model.param_tree())
        if model.tp is not None and model.tp.size > 1:
            state = fresh(abstract_params(model.param_specs()))
        tensors = {**state, "inputs": batch}
        shardings = state_shardings(model, state, rules, mesh)
        shardings["inputs"] = {k: NamedSharding(mesh, resolve_pspec(
            tuple(v.shape), lead + BATCH_AXES[k], rules, mesh))
            for k, v in batch.items()}
        return Cell(case, mesh, cfg, model, tensors, shardings,
                    tc.optimizer, grad_accum, step_fn, step_state)

    model.to(torch.bfloat16)
    tensors = {"params": model.param_tree()}  # the whole leaves
    model.split_over_model(mesh.at(0), rules)
    shardings = {"params": param_shardings(model.param_specs(), rules, mesh)}
    if case.mode == "prefill":
        tensors["inputs"] = inputs
        shardings["inputs"] = {k: NamedSharding(mesh, resolve_pspec(
            tuple(v.shape), BATCH_AXES[k], rules, mesh))
            for k, v in inputs.items()}
    else:
        caches, token, _ = inputs
        tensors["caches"] = caches
        tensors["inputs"] = {"tokens": token}
        shardings["caches"] = tree_shardings(caches, model.cache_axes(),
                                             rules, mesh)
        shardings["inputs"] = {"tokens": NamedSharding(mesh, resolve_pspec(
            tuple(token.shape), ("cache_batch", None), rules, mesh))}
    return Cell(case, mesh, cfg, model, tensors, shardings)


def rank_bytes(cell: Cell, kind: str) -> list[int]:
    """Every rank's bytes of ``cell.tensors[kind]``, each leaf's block cut
    by `local_slices` at that rank's coordinate."""
    leaves = tree_leaves(cell.tensors[kind])
    shs = tree_leaves(cell.shardings[kind])
    assert len(leaves) == len(shs), kind
    groups = Counter((tuple(x.shape), x.element_size(), sh.placements)
                     for x, sh in zip(leaves, shs))
    out = []
    for r in range(cell.mesh.size()):
        at = cell.mesh.at(r)
        n = 0
        for (shape, size, placements), k in groups.items():
            n += k * size * math.prod(
                s.stop - s.start for s in local_slices(shape, at, placements))
        out.append(n)
    return out


def cell_memory(cell: Cell) -> dict:
    """Bytes a device: each kind's largest rank, and every rank's total."""
    per_kind = {kind: rank_bytes(cell, kind) for kind in cell.tensors}
    totals = [sum(v) for v in zip(*per_kind.values())]
    mem = {f"{kind}_bytes": max(v) for kind, v in per_kind.items()}
    mem["total_bytes"] = max(totals)
    mem["per_rank"] = {"min": min(totals), "max": max(totals)}
    if cell.mode == "decode":
        port = tensor_bytes(cell.local_inputs()[0])
        if port != per_kind["caches"][0]:
            mem["port_caches_bytes"] = port
    return mem


def model_flops(cfg, case: ShapeCase, chips: int) -> float:
    """The reference's convention: 6ND train, 2ND prefill, 2NB decode, N
    the active parameters, over the chips."""
    n = cfg.n_active_params()
    if case.mode == "train":
        total = 6.0 * n * case.global_batch * case.seq_len
    elif case.mode == "prefill":
        total = 2.0 * n * case.global_batch * case.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n * case.global_batch
    return total / chips


def _shards(mesh, sh: NamedSharding) -> int:
    n = 1
    for i, pl in enumerate(sh.placements):
        if pl.is_shard():
            n *= mesh.size(i)
    return n


def cell_collectives(cell: Cell, model_bytes: float = 0.0
                     ) -> tuple[dict, str]:
    """({kind: one device's bytes}, what they stand for); ``model_bytes``
    the operands of the model's all_reduces over "model" in the step."""
    mesh = cell.mesh
    params = tree_leaves(cell.tensors["params"])
    p_sh = tree_leaves(cell.shardings["params"])
    names = list(mesh.mesh_dim_names)
    m = mesh.size(names.index("model")) if "model" in names else 1
    plan = cell.model.split_plan
    hows = tree_leaves(plan) if plan is not None else ["whole"] * len(params)
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    for x, sh, how in zip(params, p_sh, hows):
        n, nbytes = _shards(mesh, sh), tensor_bytes(x)
        if isinstance(how, int):  # gathered over the other mesh dims
            n, nbytes = n // m, nbytes / m
        if n > 1:
            out["all-gather"] += ring_bytes("all-gather", nbytes, n)
    if cell.mode != "train":
        out["all-reduce"] += ring_bytes("all-reduce", model_bytes, m)
        return out, ("the parameter gather over the mesh dims other than "
                     "\"model\" where the model holds a block; the model's "
                     "all_reduces over \"model\"")
    # the gradients (float32; each rank's block of a leaf the model holds
    # split) enter Partial on the batch's mesh dims and are redistributed
    # to the parameters' placements: a reduce-scatter where a dim shards
    # the parameter, else an all-reduce; a leaf read whole inside a split
    # region is then all-reduced over "model"; the loss is all-reduced
    tok = cell.shardings["inputs"]["tokens"]
    batch_dims = [i for i, pl in enumerate(tok.placements) if pl.is_shard()]
    for x, sh, how in zip(params, p_sh, hows):
        nbytes = float(tensor_bytes(x)) / (m if isinstance(how, int) else 1)
        for i in batch_dims:
            n = mesh.size(i)
            if sh.placements[i].is_shard():
                out["reduce-scatter"] += ring_bytes("reduce-scatter",
                                                    nbytes, n)
                nbytes /= n
            else:
                out["all-reduce"] += ring_bytes("all-reduce", nbytes, n)
        if how == "partial":
            out["all-reduce"] += ring_bytes("all-reduce", nbytes, m)
    for i in batch_dims:
        out["all-reduce"] += ring_bytes("all-reduce", 4.0, mesh.size(i))
    out["all-reduce"] += ring_bytes("all-reduce", model_bytes, m)
    return out, ("_DataParallel's parameter gather, its gradient "
                 "reduction and the loss's all-reduce, over the mesh dims "
                 "other than \"model\" where the model holds a block; the "
                 "model's all_reduces over \"model\"")


def cell_cost(cell: Cell) -> dict:
    """The step on one rank's rows under the flop and byte counters, and
    the three terms."""
    args = cell.local_inputs()
    counts = cell.model.tp.counts if cell.model.tp else Counter()
    before = counts["all-reduce"]
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        cell.step(args)
    model_bytes = float(counts["all-reduce"] - before)
    colls, note = cell_collectives(cell, model_bytes)
    cost = {
        "flops": float(fc.get_total_flops()),
        "bytes_accessed": float(bc.bytes),
        "bytes_model": "unfused",
        "model_flops": model_flops(cell.cfg, cell.case, cell.mesh.size()),
        "model_axis": cell.model_axis,
        "model_all_reduce_bytes": model_bytes,
        "rows_per_device": cell.rows,
        "collective_bytes": sum(colls.values()),
        "collectives": colls,
        "collective_note": note,
    }
    cost["compute_s"] = cost["flops"] / RATES["flops_s"]["value"]
    cost["memory_s"] = cost["bytes_accessed"] / RATES["hbm_bytes_s"]["value"]
    cost["collective_s"] = (cost["collective_bytes"]
                            / RATES["net_bytes_s"]["value"])
    cost["bound"] = max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: cost[k])
    cost["rates"] = {k: v["name"] for k, v in RATES.items()}
    return cost


def run_cell(arch: str, shape: str, mesh_name: str, rules_overrides=None,
             optimizer: str | None = None, cfg_overrides=None,
             grad_accum: int = 1) -> dict:
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "mode": SHAPES[shape].mode, "ok": False}
    runnable, reason = cell_runnable(cfg, shape)
    if not runnable:
        rec.update(skipped=True, reason=reason, ok=True)
        return rec
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    rules = ShardingRules.default(multi_pod=mesh_name == "multi_pod")
    if rules_overrides:
        rules = rules.with_overrides(**rules_overrides)
    try:
        t0 = time.monotonic()
        cell = build_cell(arch, shape, mesh_name, rules=rules,
                          optimizer=optimizer, cfg=cfg,
                          grad_accum=grad_accum)
        memory = cell_memory(cell)
        t1 = time.monotonic()
        cost = cell_cost(cell)
        rec.update(ok=True, devices=cell.mesh.size(),
                   build_s=round(t1 - t0, 2),
                   cost_s=round(time.monotonic() - t1, 2),
                   memory=memory, cost=cost)
        if cell.optimizer:
            rec["optimizer"] = cell.optimizer
    except Exception as e:  # a failure here is a bug in the system
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def card_check(rec: dict, *, device="cuda", reps: int = 3) -> dict:
    """A one_card record's cell built on the card (no CPU fallback): the
    bytes of its tensors and the allocator's growth while they were made;
    for prefill and decode the step's FLOPs under ``FlopCounterMode``,
    its mean ms over ``reps`` (CUDA events, after the counted call) and
    its peak memory; for train the state of ``Trainer.init_state``, no
    step."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"card_check runs on a card, not {device!r}")
    if rec["mesh"] != "one_card":
        raise ValueError(f"card_check takes a one_card record, not "
                         f"{rec['mesh']!r}")
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(dev).manual_seed(0)
    out = {"arch": rec["arch"], "shape": rec["shape"]}
    if rec["mode"] == "train":
        model = TransformerLM(get_config(rec["arch"]), device=dev,
                              generator=gen)
        trainer = Trainer(model, TrainerConfig(optimizer=rec["optimizer"]))
        tensors = trainer.init_state()
    else:
        cell = build_cell(rec["arch"], rec["shape"], "one_card", device=dev,
                          generator=gen)
        tensors = cell.tensors
    torch.cuda.synchronize(dev)
    out["allocated_bytes"] = torch.cuda.memory_allocated(dev) - base
    out.update({f"{kind}_bytes": tensor_bytes(t)
                for kind, t in tensors.items()})
    out["tensor_bytes"] = tensor_bytes(tensors)
    out["rounding_bytes"] = allocator_rounding(tensors)
    if rec["mode"] == "train":
        return out
    args = cell.local_inputs()
    torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as fc:
        cell.step(args)
    out["flops"] = float(fc.get_total_flops())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        cell.step(args)
    end.record()
    torch.cuda.synchronize(dev)
    out["step_ms"] = start.elapsed_time(end) / reps
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    return out


def _parse_value(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single_pod", choices=list(MESHES))
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--rules", nargs="*", default=[],
                    help="logical=mesh overrides, e.g. cache_seq=model "
                         "or d_ff=data,model ('' = replicate)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--cfg", nargs="*", default=[],
                    help="ModelConfig overrides, e.g. remat=none")
    args = ap.parse_args(argv)

    cfg_overrides = {}
    for kv in args.cfg:
        k, _, v = kv.partition("=")
        cfg_overrides[k] = _parse_value(v)
    overrides = {}
    for kv in args.rules:
        k, _, v = kv.partition("=")
        axes = tuple(x for x in v.split(",") if x)
        overrides[k] = axes if len(axes) > 1 else (axes[0] if axes else None)

    rec = run_cell(args.arch, args.shape, args.mesh, overrides,
                   args.optimizer, cfg_overrides, args.grad_accum)
    print(json.dumps(rec, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    sys.exit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
