"""The power spectrogram of a real capture already on the device, through
`repro_torch.core.spectral.power_spectrogram(x, frame, hop)`: frames of
``shape`` [frame] samples every ``hop``, the periodic Hann window, the r2c
transform of every frame (K3), and |X|^2 of the one-sided bins.

A pool of ``pool`` captures of ``samples`` Gaussian float32 samples is made
from the seed, on the device, and call i analyses capture i mod pool. ``in_bytes`` is the capture's bytes, so that the rate is capture
through the analysis. `check` holds every bin of a call's output to the
float64 reference (`portbench.spectrogram_reference`), computed in blocks
of frames; `control` holds the reference computed in TF32 to the same.
"""

from __future__ import annotations

import torch

from portbench import reference, spectrogram_reference, spectrogram_work

REF_POINTS = 1 << 24   # points of the frames a block of the reference holds


class Driver:
    kind = "r2c"

    def __init__(self, ctx):
        from repro_torch.core import spectral

        cfg = ctx.config
        (self.frame,) = cfg["shape"]
        self.hop = cfg["hop"]
        self.frames = spectrogram_work.frames(cfg)
        if (cfg["samples"] - self.frame) // self.hop + 1 != self.frames:
            raise ValueError(f"batch_shape {cfg['batch_shape']} is not the "
                             f"frames of {cfg['samples']} samples at frame "
                             f"{self.frame}, hop {self.hop}")
        if cfg["window"] != "hann_periodic" or cfg["output"] != "power":
            raise ValueError("this entry runs the periodic Hann window and "
                             "the power alone")
        self.spectrogram = spectral.power_spectrogram
        self.device = ctx.device
        self.in_bytes = spectrogram_work.in_bytes(cfg)
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed)
        self.pool = [torch.randn(cfg["samples"], generator=gen,
                                 device=ctx.device)
                     for _ in range(ctx.traffic["pool"])]
        self.per_block = max(1, REF_POINTS // self.frame)

    def call(self, i):
        return self.spectrogram(self.pool[i % len(self.pool)], self.frame,
                                self.hop, device=self.device)

    def _gap(self, i, power_of) -> dict:
        """Gap to the float64 reference of capture i's power of what
        ``power_of(f0, f1, cache)`` gives for each block of frames."""
        x = self.pool[i % len(self.pool)]
        zero = torch.zeros((), dtype=torch.float64, device=self.device)
        gap, cache = reference.Gap(), {}
        for f0, f1 in spectrogram_reference.blocks(self.frames,
                                                   self.per_block):
            want = spectrogram_reference.power(x, self.frame, self.hop, f0,
                                               f1, "float64", cache)
            gap.add(power_of(f0, f1, cache), zero, want, zero)
        return gap.numbers()

    def check(self, i, out) -> dict:
        return self._gap(i, lambda f0, f1, cache: out[f0:f1])

    def control(self, i) -> dict:
        x = self.pool[i % len(self.pool)]
        return self._gap(i, lambda f0, f1, cache: spectrogram_reference.power(
            x, self.frame, self.hop, f0, f1, "tf32", cache))
