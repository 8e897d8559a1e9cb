"""Local r2c transforms of real operands already on the device, through
`repro_torch.fft.plan(kind="r2c", ...)` and `ExecutablePlan.execute_real`:
the one-sided spectrum of the last axis, full along the others."""

from __future__ import annotations

import torch

from portbench.entries import execute


class Driver(execute.Driver):
    kind = "r2c"

    def operand(self, shape, gen, device):
        return (torch.randn(shape, generator=gen, device=device),)

    def call(self, i):
        return self.plan.execute_real(*self.pool[i % len(self.pool)])
