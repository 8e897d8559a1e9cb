"""Training loop: the step, the optimizer state, sharded state on a mesh,
resume.

The step is the JAX package's ``train_step`` in torch ops:

    state = {params, opt_state, step[, errors]}
    train_step(state, batch) -> (state, metrics)

On one device ``state["params"]`` is the model's own parameter tree
(`TransformerLM.param_tree`): the gradients come from ``torch.autograd``
over `TransformerLM.loss`, and the optimizer writes the new values into
those tensors in place, as the reference donates its state.

On a mesh (``Trainer(mesh=DeviceMesh)``) every leaf of the state is a
DTensor placed by `state_shardings`, the reference's rule: the
parameters by the sharding rules (ZeRO-3), every other leaf like the
parameter of identical shape (ZeRO-1 moments, compression errors), else
replicated. The step is data-parallel over the mesh dims of the batch
rule and tensor-parallel over "model", as the rules decide:

* the model holds this rank's block of every leaf the rules split on
  "model" and computes its block of the products that read it
  (`TransformerLM.split_over_model`, `repro_torch.sharding.
  tensor_parallel`: every collective of the model is an all_reduce over
  "model"); families that compute replicated over "model", and rules
  that split nothing there (``with_overrides(heads=None, kv_heads=None,
  d_ff=None, vocab=None)``), hold every leaf whole;
* every rank is given the same global batch and keeps its own rows by
  its mesh coordinate; it gathers the model's parameters from the state
  over the mesh dims other than "model" only (no collective where those
  have size 1), weights its loss by its share of the global mask count
  (so the ranks' losses sum to the reference's masked mean over the
  global batch), and its gradients enter as DTensors, ``Partial``
  on the batch's mesh dims, ``Shard`` on "model" where the model holds
  a block, ``Partial`` there too where it reads a whole leaf inside a
  split region (each rank's gradient a share of the whole), else
  replicated, redistributed to the parameters' placements. The loss is
  the same on every rank of "model".

Clipping, compression and the optimizer then run unchanged over
DTensors.

Fault tolerance: async keep-N checkpoints in the reference's layout (one
global array a leaf, from a mesh too), auto-resume from the newest
committed step, and the elastic restore: a state saved on one mesh
restores onto the shardings of whatever mesh (or none) the trainer has.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.compression import compress_tree, init_error_state
from repro_torch.optim.optimizers import clip_by_global_norm, get_optimizer
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.sharding.rules import (NamedSharding, ShardingRules,
                                       from_block, init_params, local_slices,
                                       mesh_dim_names, model_slices,
                                       param_shardings, place, resolve_pspec)
from repro_torch.tree import (flatten_up_to, tree_flatten, tree_leaves,
                              tree_map, tree_unflatten)


@dataclass
class TrainerConfig:
    optimizer: str = "adamw"
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    grad_accum: int = 1
    grad_compression: bool = False
    weight_decay: float = 0.1
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    keep_n: int = 3
    log_every: int = 10


def _value_and_grad(model: TransformerLM, params, batch, weight=None):
    """(loss, gradients shaped like ``params``) of `TransformerLM.loss`
    over ``batch``, times ``weight`` when given; the gradients in the
    parameters' dtype (float32)."""
    leaves, tdef = tree_flatten(params)
    with torch.enable_grad():
        loss = model.loss(batch)
        if weight is not None:
            loss = loss * weight
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a parameter the loss does not reach has a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(tdef, grads)


def make_train_step(model: TransformerLM, tc: TrainerConfig, mesh=None,
                    rules: ShardingRules | None = None):
    """Build the step function; returns ``(opt, train_step)``. With
    ``mesh`` the step takes and returns a state of DTensors (`place`) and
    the global batch, as the module docstring says."""
    opt_kw = {}
    if tc.optimizer in ("adamw", "adafactor"):
        opt_kw["weight_decay"] = tc.weight_decay
    opt = get_optimizer(tc.optimizer, **opt_kw)
    lr_fn = linear_warmup_cosine(tc.base_lr, tc.warmup_steps, tc.total_steps)
    dp = None if mesh is None else _DataParallel(
        model, mesh, rules or ShardingRules.default(), tc.grad_accum)

    def train_step(state, batch):
        params = state["params"]
        weights = [None] * tc.grad_accum
        if dp is not None:
            params, batch, weights = dp.enter(params, batch)
        if tc.grad_accum > 1:
            # microbatches: batch leaves are (accum, mb, ...); the losses
            # and float32 gradients are summed, then divided
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(tc.grad_accum):
                l, g = _value_and_grad(model, params,
                                       {k: v[i] for k, v in batch.items()},
                                       weights[i])
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / tc.grad_accum
            grads = tree_map(lambda g: g / tc.grad_accum, grads)
        else:
            loss, grads = _value_and_grad(model, params, batch, weights[0])
        if dp is not None:
            loss, grads = dp.reduce(loss, grads, state)
            params = state["params"]

        new_state = dict(state)
        if tc.grad_compression:
            grads, new_state["errors"] = compress_tree(grads, state["errors"])
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        lr = lr_fn(state["step"])
        new_params, new_opt = opt.update(grads, state["opt_state"], params, lr)
        new_state.update(params=new_params, opt_state=new_opt,
                         step=state["step"] + 1)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if dp is not None:
            new_state = place(new_state, dp.shardings)
            metrics = {k: _replicated(v) for k, v in metrics.items()}
        return new_state, metrics

    return opt, train_step


# ---------------------------------------------------------------------------
# the mesh half


def state_shardings(model: TransformerLM, state, rules: ShardingRules, mesh):
    """Shardings for the full train state.

    Params use the rules; every non-param leaf is sharded like the param of
    identical shape (adamw moments, compression errors => ZeRO-1 for free),
    else replicated (adafactor's factored stats are tiny; step scalar).
    Where two params share a shape, the later in flatten order decides, as
    the reference's dict does.
    """
    pshard = param_shardings(model.param_specs(), rules, mesh)
    flat_p = {tuple(x.shape): s for x, s in zip(
        tree_leaves(state["params"]), tree_leaves(pshard))}
    rep = NamedSharding(mesh, ())

    def pick(x):
        return flat_p.get(tuple(x.shape), rep)

    sh = {k: tree_map(pick, v) for k, v in state.items() if k != "params"}
    sh["params"] = pshard
    return sh


def _replicated(x):
    """A metric as a plain tensor (a replicated DTensor's local value)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _model_placements(mesh, how) -> list:
    """The placements of the model's value of a leaf read ``how`` (a
    `TransformerLM.model_split` entry): ``Shard`` on "model" where it
    holds a block, else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(how) if n == "model" and isinstance(how, int)
            else Replicate() for n in mesh_dim_names(mesh)]


def model_value(v, how, mesh):
    """The model's value of the state leaf ``v``: its block along "model"
    where the model holds one, else the whole; ``v`` a DTensor gathered
    over the mesh dims that split it otherwise, none where they have size
    1 (then no collective), or a plain global tensor cut locally."""
    from torch.distributed.tensor import DTensor
    if not isinstance(v, DTensor):
        return v[model_slices(v.shape, how if isinstance(how, int) else None,
                              mesh)]
    want = _model_placements(mesh, how)
    if all(a == b or mesh.size(i) == 1
           for i, (a, b) in enumerate(zip(v.placements, want))):
        return v.to_local()
    return v.redistribute(mesh, want).to_local()


class _DataParallel:
    """The mesh half of a step: this rank's rows, the parameters gathered
    into the model (this rank's blocks along "model"), the loss weights,
    the gradients' reduction."""

    def __init__(self, model, mesh, rules: ShardingRules, accum: int):
        self.model, self.mesh, self.rules, self.accum = (model, mesh, rules,
                                                         accum)
        self.plan = model.split_over_model(mesh, rules)
        self.bdim = 1 if accum > 1 else 0  # microbatches lead under accum
        self.shardings = None  # the state's, from the first step's state
        self.partial = None  # the loss's placements: Partial on the
        #                      batch's mesh dims of more than one rank

    def _batch_sharding(self, n_rows: int) -> NamedSharding:
        """The batch dim's sharding: the mesh dims its rule resolves to."""
        entry = resolve_pspec((n_rows,), ("batch",), self.rules, self.mesh)[0]
        return NamedSharding(self.mesh, (None,) * self.bdim + (entry,))

    def enter(self, params, batch):
        """(the model's parameter tree holding the gathered values, this
        rank's rows of ``batch``, a loss weight a microbatch)."""
        model = self.model
        leaves, tdef = tree_flatten(model.param_tree())
        with torch.no_grad():
            for p, v, how in zip(leaves, flatten_up_to(tdef, params),
                                 flatten_up_to(tdef, self.plan)):
                p.copy_(model_value(v, how, self.mesh))  # the gather
        from torch.distributed.tensor import Partial, Replicate, Shard
        sh = self._batch_sharding(batch["tokens"].shape[self.bdim])
        self.partial = [Partial() if isinstance(pl, Shard)
                        and self.mesh.size(i) > 1 else Replicate()
                        for i, pl in enumerate(sh.placements)]
        rows = {k: v[local_slices(v.shape[:self.bdim + 1], self.mesh,
                                  sh.placements)]
                for k, v in batch.items()}
        weights = [self._weight(batch, rows, i) for i in range(self.accum)]
        return model.param_tree(), rows, weights

    def _weight(self, batch, rows, i):
        """This rank's mask count over the global count (each at least 1,
        as `TransformerLM.loss` clamps it) for microbatch ``i``."""
        def count(b):
            t = b["tokens"][i] if self.accum > 1 else b["tokens"]
            m = b.get("loss_mask")
            if m is None:
                return torch.tensor(float(t.shape[0] * (t.shape[1] - 1)),
                                    device=t.device)
            m = m[i] if self.accum > 1 else m
            return m[:, 1:].to(torch.float32).sum().to(t.device)
        return (torch.clamp(count(rows), min=1.0)
                / torch.clamp(count(batch), min=1.0))

    def _grad_placements(self, how) -> list:
        """A gradient's placements as `_value_and_grad` leaves it: Partial
        on the batch's mesh dims; on "model" Shard where the model holds a
        block, Partial where it reads the whole leaf inside a split region
        (`TransformerLM.model_split`); replicated on a dim of one."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        out = []
        for i, (name, pl) in enumerate(zip(mesh_dim_names(self.mesh),
                                           self.partial)):
            if name != "model" or self.mesh.size(i) == 1:
                out.append(pl)
            elif isinstance(how, int):
                out.append(Shard(how))
            else:
                out.append(Partial() if how == "partial" else Replicate())
        return out

    def reduce(self, loss, grads, state):
        """The ranks' weighted losses summed, and the gradients summed over
        the batch's mesh dims (and over "model" where each rank's is a
        share) onto the parameters' placements."""
        from torch.distributed.tensor import DTensor
        if self.shardings is None:
            self.shardings = state_shardings(self.model, state, self.rules,
                                             self.mesh)
        loss = DTensor.from_local(loss, self.mesh, self.partial).full_tensor()

        def one(g, v, sh, how):
            return DTensor.from_local(
                g, self.mesh, self._grad_placements(how), run_check=False,
                shape=v.shape, stride=v.stride()).redistribute(
                    self.mesh, sh.placements)
        grads = tree_map(one, grads, state["params"],
                         self.shardings["params"], self.plan)
        return loss, grads


class Trainer:
    def __init__(self, model: TransformerLM, tc: TrainerConfig,
                 mesh=None, rules: ShardingRules | None = None):
        if mesh is not None and getattr(mesh, "mesh_dim_names", None) is None:
            raise TypeError("Trainer(mesh=...) takes a DeviceMesh with named "
                            f"dims, not {type(mesh).__name__}")
        self.model = model
        self.tc = tc
        self.mesh = mesh
        self.rules = rules or ShardingRules.default()
        self.opt, self._step_fn = make_train_step(model, tc, mesh, self.rules)
        self.ckpt = (CheckpointManager(tc.ckpt_dir, tc.keep_n, mesh=mesh)
                     if tc.ckpt_dir else None)

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None):
        """A fresh state over the model's parameters; with ``generator``
        (on the model's device) the parameters are drawn anew from it
        with the reference's initializers. With a mesh the state is placed
        on it (`state_shardings`), every leaf a DTensor holding a copy of
        this rank's block (the reference leaves a fresh state on one
        device; the values are the same), the parameters cut from the
        model's blocks with no collective."""
        model = self.model
        if generator is not None:
            fresh = init_params(model.param_specs(), generator, model.device)
            self._load_params(fresh)
            del fresh
        params = (model.param_tree() if self.mesh is None
                  else self._placed_params())
        state = {"params": params, "opt_state": self.opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=model.device)}
        if self.tc.grad_compression:
            state["errors"] = init_error_state(params)
        if self.mesh is not None:
            state = place(state, self.state_shardings(state))
        return state

    def _placed_params(self):
        """The parameters as DTensors on their shardings, each rank's
        block a copy cut from the model's value of the leaf (its block
        along "model", which holds the rank's block)."""
        model, mesh = self.model, self.mesh
        specs = model.param_specs()

        def one(p, ps, sh, how):
            idx = list(local_slices(ps.shape, mesh, sh.placements))
            if isinstance(how, int) and p.shape != ps.shape:
                idx[how] = slice(None)  # the model holds that dim's block
            return from_block(p.detach()[tuple(idx)].clone(
                memory_format=torch.contiguous_format), ps.shape, sh)
        return tree_map(one, model.param_tree(), specs,
                        param_shardings(specs, self.rules, mesh),
                        model.split_plan)

    def state_shardings(self, state):
        if self.mesh is None:
            return None
        return state_shardings(self.model, state, self.rules, self.mesh)

    @torch.no_grad()
    def _load_params(self, tree) -> None:
        """Copy ``tree`` (the parameters' nesting, global values: plain
        tensors or DTensors) into the model's parameters, on a mesh each
        the model's value of the leaf (`model_value`)."""
        leaves, tdef = tree_flatten(self.model.param_tree())
        values = flatten_up_to(tdef, tree)
        if self.mesh is not None:
            values = [model_value(v, how, self.mesh) for v, how in
                      zip(values, flatten_up_to(tdef,
                                                self.model.split_plan))]
        for p, v in zip(leaves, values):
            p.copy_(v)

    def restore_or_init(self, generator: torch.Generator | None = None):
        """The newest committed checkpoint's state on the model's device
        (its parameters copied into the model's), else `init_state`. With
        a mesh each leaf is this rank's block of the saved global array,
        on the placements of this trainer's mesh, whatever mesh saved it
        (the elastic restore)."""
        state = self.init_state(generator)
        if self.ckpt is not None and self.ckpt.latest() is not None:
            if self.mesh is not None:
                _, state = self.ckpt.restore_latest(
                    state, shardings=self.state_shardings(state))
                self._load_params(state["params"])
                return state
            _, restored = self.ckpt.restore_latest(state, self.model.device)
            self._load_params(restored.pop("params"))
            restored["params"] = state["params"]
            state = restored
        return state

    # ------------------------------------------------------------------
    def run(self, state, data_iter, steps: int):
        """Train ``steps`` steps; returns (state, list of metrics dicts).

        Each batch moves to the model's device (on a mesh every rank is
        given the global batch and keeps its rows). The metrics stay tensors
        on the device until a logged step (every ``log_every`` and the
        last), which is the only place the loop waits for the card. A
        checkpoint is saved every ``ckpt_every`` steps and at the end
        (once, when the end is such a step), and the last save is waited
        for. On a mesh the model's parameters are then loaded with the
        state's (one gather), so that ``self.model`` holds the trained
        weights, as it does on one device.
        """
        tc = self.tc
        dev = self.model.device
        history = []
        saved = None
        step = int(state["step"])  # counted on the host from here on
        t0 = time.monotonic()
        for i, batch in enumerate(data_iter):
            if i >= steps:
                break
            batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                     for k, v in batch.items()}
            state, metrics = self._step_fn(state, batch)
            step += 1
            if step % tc.log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = time.monotonic() - t0
                history.append(m)
            if self.ckpt is not None and step % tc.ckpt_every == 0:
                self.ckpt.save_async(step, state)
                saved = step
        if self.ckpt is not None:
            if saved != step:
                self.ckpt.save_async(step, state)
            self.ckpt.wait()
        if self.mesh is not None:
            # the model holds the values gathered before the last update
            self._load_params(state["params"])
        return state, history
