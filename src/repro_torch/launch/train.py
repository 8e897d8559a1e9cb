"""Training launcher: trains any assigned arch, reduced or at its published
widths, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 64 \\
      --ckpt-dir build/train_ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 30 --batch 8 --seq 512 --ckpt-dir build/train_ckpt

The model runs on the CUDA card (``--device cuda``, the default; no card
is an error before any work) or, with ``--device cpu``, on the host.
``--num-layers`` cuts the depth. The parameters are drawn from a
``torch.Generator`` seeded with ``--seed`` with the reference's
initializers (``--qk-fan-in``: wq and wk at their true fan-in, without
which the published widths do not train at full depth); the corpus is the
reference's seeded Zipf stream (`repro_torch.data.synthetic_corpus`) in a
BlockStore under ``--data-dir``. The run resumes from the newest
committed checkpoint in ``--ckpt-dir`` (kill it mid-run and relaunch to
see the fault-tolerance path). It prints the reference's JSON lines, one
a logged step, and `main` returns a report: the history, the step it
resumed from, the device, each step's time (CUDA events recorded as the
loop takes the next batch, read once at the end, on the card; the host
clock on the CPU), the steady step time and tokens/s (from the fourth
step on, the steps that ended in a checkpoint left out), peak device
memory, the checkpoints' seconds and bytes, and the final state.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import TokenPipeline, synthetic_corpus
from repro_torch.fft.spec import resolve_device
from repro_torch.models.transformer import TransformerLM
from repro_torch.train.trainer import Trainer, TrainerConfig


class _StepClock:
    """Wraps the batch iterator and marks the time each batch is taken,
    which is when the previous step has been launched: CUDA events on the
    card (no synchronization per step), the host clock on the CPU."""

    def __init__(self, it, device: torch.device):
        self.it, self.cuda = it, device.type == "cuda"
        self.marks = []

    def __iter__(self):
        for batch in self.it:
            self._mark()
            yield batch

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self, steps: int) -> list[float]:
        """The ms of each of the first ``steps`` steps: from its batch's
        mark to the next (the loop takes one batch past the last step)."""
        marks = self.marks[:steps + 1]
        if self.cuda:
            marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-dir", default="build/repro_corpus")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--qk-fan-in", action="store_true",
                    help="draw wq and wk with the std of their true fan-in "
                         "(TransformerLM.rescale_qk_to_fan_in); the "
                         "reference's init does not train at full depth")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # no card: fail before any work
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    model = TransformerLM(cfg, device=device, generator=torch.Generator(
        device).manual_seed(args.seed))
    if args.qk_fan_in:
        model.rescale_qk_to_fan_in()

    store = synthetic_corpus(args.data_dir, vocab_size=cfg.vocab_size,
                             n_tokens=max(4_000_000,
                                          args.batch * (args.seq + 1) * 50),
                             seed=args.seed)
    pipe = TokenPipeline(store, batch=args.batch, seq=args.seq)

    tc = TrainerConfig(optimizer=args.optimizer, base_lr=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps,
                       grad_compression=args.grad_compression,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    trainer = Trainer(model, tc)
    state = trainer.restore_or_init()  # the parameters drawn above
    start = int(state["step"])
    if start:
        print(f"resumed from step {start}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    steps = args.steps - start
    clock = _StepClock(iter(pipe), device)
    t0 = time.monotonic()
    state, history = trainer.run(state, iter(clock), steps=steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.monotonic() - t0
    for m in history:
        print(json.dumps(m))
    step_ms = clock.step_ms(steps)
    saves = trainer.ckpt.saves if trainer.ckpt else []
    # steady state: from the fourth step on, without the steps that ended
    # in a checkpoint's device->host snapshot
    saved = {s["step"] - start for s in saves}
    steady = [t for i, t in enumerate(step_ms)
              if i >= 3 and i + 1 not in saved]
    tokens = args.batch * args.seq
    return {
        "arch": cfg.name, "device": str(device),
        "params": sum(p.numel() for p in model.parameters()),
        "resumed_from": start, "steps": steps, "history": history,
        "step_ms": step_ms,
        "steady_step_ms": sum(steady) / len(steady) if steady else None,
        "tokens_per_step": tokens,
        "tok_s": (tokens / (sum(steady) / len(steady) * 1e-3)
                  if steady else None),
        "wall_s": wall_s,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "checkpoints": saves,
        "state": state}


if __name__ == "__main__":
    main()
