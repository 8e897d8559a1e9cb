"""Training loop on one device: the step, the optimizer state, resume.

The step is the JAX package's ``train_step`` in torch ops:

    state = {params, opt_state, step[, errors]}
    train_step(state, batch) -> (state, metrics)

``state["params"]`` is the model's own parameter tree (`TransformerLM.
param_tree`): the gradients come from ``torch.autograd`` over
`TransformerLM.loss`, and the optimizer writes the new values into those
tensors in place, as the reference donates its state. Fault tolerance:
async keep-N checkpoints in the reference's layout, and auto-resume from
the newest committed step.

Training on a mesh (the train state's shardings, ``Trainer(mesh=...)``,
a restore onto a mesh of another width) is ROADMAP.md Queue 1 item 12d.
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
from repro_torch.sharding.rules import ShardingRules, init_params
from repro_torch.tree import (flatten_up_to, tree_flatten, tree_map,
                              tree_unflatten)


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


def _value_and_grad(model: TransformerLM, params, batch):
    """(loss, gradients shaped like ``params``) of `TransformerLM.loss`
    over ``batch``; the gradients in the parameters' dtype (float32)."""
    leaves, tdef = tree_flatten(params)
    with torch.enable_grad():
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a parameter the loss does not reach has a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(tdef, grads)


def make_train_step(model: TransformerLM, tc: TrainerConfig):
    """Build the step function; returns ``(opt, train_step)``."""
    opt_kw = {}
    if tc.optimizer in ("adamw", "adafactor"):
        opt_kw["weight_decay"] = tc.weight_decay
    opt = get_optimizer(tc.optimizer, **opt_kw)
    lr_fn = linear_warmup_cosine(tc.base_lr, tc.warmup_steps, tc.total_steps)

    def train_step(state, batch):
        params = state["params"]
        if tc.grad_accum > 1:
            # microbatches: batch leaves are (accum, mb, ...); the losses
            # and float32 gradients are summed, then divided
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(tc.grad_accum):
                l, g = _value_and_grad(model, params,
                                       {k: v[i] for k, v in batch.items()})
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / tc.grad_accum
            grads = tree_map(lambda g: g / tc.grad_accum, grads)
        else:
            loss, grads = _value_and_grad(model, params, batch)

        new_state = dict(state)
        if tc.grad_compression:
            grads, new_state["errors"] = compress_tree(grads, state["errors"])
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        lr = lr_fn(state["step"])
        new_params, new_opt = opt.update(grads, state["opt_state"], params, lr)
        new_state.update(params=new_params, opt_state=new_opt,
                         step=state["step"] + 1)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_state, metrics

    return opt, train_step


class Trainer:
    def __init__(self, model: TransformerLM, tc: TrainerConfig,
                 mesh=None, rules: ShardingRules | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): training on a mesh is ROADMAP.md Queue 1 "
                "item 12d; this trainer runs on the model's one device")
        self.model = model
        self.tc = tc
        self.rules = rules or ShardingRules.default()
        self.opt, self._step_fn = make_train_step(model, tc)
        self.ckpt = (CheckpointManager(tc.ckpt_dir, tc.keep_n)
                     if tc.ckpt_dir else None)

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None):
        """A fresh state over the model's parameters; with ``generator``
        (on the model's device) the parameters are drawn anew from it
        with the reference's initializers."""
        model = self.model
        if generator is not None:
            fresh = init_params(model.param_specs(), generator, model.device)
            self._load_params(fresh)
        params = model.param_tree()
        state = {"params": params, "opt_state": self.opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=model.device)}
        if self.tc.grad_compression:
            state["errors"] = init_error_state(params)
        return state

    @torch.no_grad()
    def _load_params(self, tree) -> None:
        """Copy ``tree`` (the parameters' nesting) into the model's
        parameters."""
        leaves, tdef = tree_flatten(self.model.param_tree())
        for p, v in zip(leaves, flatten_up_to(tdef, tree)):
            p.copy_(v)

    def restore_or_init(self, generator: torch.Generator | None = None):
        """The newest committed checkpoint's state on the model's device
        (its parameters copied into the model's), else `init_state`."""
        state = self.init_state(generator)
        if self.ckpt is not None and self.ckpt.latest() is not None:
            _, restored = self.ckpt.restore_latest(state, self.model.device)
            self._load_params(restored.pop("params"))
            restored["params"] = state["params"]
            state = restored
        return state

    # ------------------------------------------------------------------
    def run(self, state, data_iter, steps: int):
        """Train ``steps`` steps; returns (state, list of metrics dicts).

        Each batch moves to the model's device. The metrics stay tensors
        on the device until a logged step (every ``log_every`` and the
        last), which is the only place the loop waits for the card. A
        checkpoint is saved every ``ckpt_every`` steps and at the end
        (once, when the end is such a step), and the last save is waited
        for.
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
        return state, history
