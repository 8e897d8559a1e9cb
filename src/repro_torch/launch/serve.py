"""Serving launcher: batched prefill + greedy decode of a `TransformerLM`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 8 --prompt-len 512 --new-tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --device cpu

The model runs on the CUDA card (``--device cuda``, the default; no card
is an error) or, with ``--device cpu``, on the host. ``--num-layers``
cuts the depth (a model too large for the card at its full depth runs
at its published widths with fewer layers). The parameters are drawn
from a ``torch.Generator`` seeded with ``--seed``; the prompt tokens,
then the reference's stub inputs (64 frames of ``d_model`` for the
encoder-decoder, ``num_prefix_embeds`` patches for the VLM, float32)
from numpy's generator with the same seed, in the reference's order.
The first call and a second, steady-state call are timed apart, each
between two ``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.fft.spec import resolve_device
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import ServeEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # no card: fail before any work
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    generator = torch.Generator(device).manual_seed(args.seed)
    model = TransformerLM(cfg, device=device, generator=generator)

    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (args.batch, args.prompt_len)))}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (args.batch, 64, cfg.d_model)).astype(np.float32))
    if cfg.num_prefix_embeds:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.num_prefix_embeds, cfg.d_model)).astype(
                np.float32))

    engine = ServeEngine(model)
    total = args.batch * args.new_tokens
    # the first call pays the library's warm-up; time it separately so the
    # steady-state number reflects actual serving throughput
    times = []
    for _ in range(2):
        _sync(device)
        t0 = time.monotonic()
        out = engine.generate(batch, args.new_tokens)
        _sync(device)
        times.append(time.monotonic() - t0)
    first, steady = times
    print(f"generated {tuple(out.shape)}")
    print(f"first call (incl. warm-up): {first:.2f}s "
          f"({total / first:.1f} tok/s)")
    print(f"steady state:               {steady:.2f}s "
          f"({total / steady:.1f} tok/s)")
    print(out[:2].cpu().numpy())
    return {"arch": cfg.name, "device": str(device), "tokens": out,
            "first_s": first, "steady_s": steady,
            "tok_s": total / steady}


if __name__ == "__main__":
    main()
