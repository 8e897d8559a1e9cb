"""Local c2c transforms of planar operands already on the device, through
`repro_torch.fft.plan(...)` and `ExecutablePlan.execute`.

The driver makes a pool of ``pool`` distinct operands from the seed, on the
device, and call i transforms operand i mod pool. `check` holds a call's
output to the float64 DFT of its operand, every bin of it; `control` holds
the reference computed in TF32 to the same.
"""

from __future__ import annotations

import math

import torch

from portbench import reference, work

REF_POINTS = 1 << 22   # points a block of the reference transforms at once


class Driver:
    kind = "c2c"

    def __init__(self, ctx):
        import repro_torch.fft

        cfg = ctx.config
        self.device = ctx.device
        self.ndim = len(cfg["shape"])
        self.in_bytes = work.in_bytes(self.kind, cfg)
        self.plan = repro_torch.fft.plan(
            kind=self.kind, shape=tuple(cfg["shape"]),
            batch_shape=tuple(cfg["batch_shape"]), device=str(ctx.device))
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed)
        shape = (*cfg["batch_shape"], *cfg["shape"])
        self.pool = [self.operand(shape, gen, ctx.device)
                     for _ in range(ctx.traffic["pool"])]
        self.rows = max(1, REF_POINTS // math.prod(cfg["shape"]))

    def operand(self, shape, gen, device):
        return tuple(torch.randn(shape, generator=gen, device=device)
                     for _ in range(2))

    def call(self, i):
        return self.plan.execute(*self.pool[i % len(self.pool)])

    def operand_of(self, i):
        """Call i's operand on the device, for the reference."""
        return self.pool[i % len(self.pool)]

    def _gap(self, i, precision_out):
        """Gap to the float64 reference of operand i's transform of the
        output ``precision_out(sl)`` gives for each block of rows."""
        x = self.operand_of(i)
        xr, xi = (x[0], None) if self.kind == "r2c" else x
        gap = reference.Gap()
        for sl, rr, ri in reference.transform_rows(
                xr, xi, self.ndim, self.kind, "float64", self.rows):
            gap.add(*precision_out(sl), rr, ri)
        return gap.numbers()

    def check(self, i, out) -> dict:
        return self._gap(i, lambda sl: (out[0][sl], out[1][sl]))

    def control(self, i) -> dict:
        x = self.operand_of(i)
        xr, xi = (x[0], None) if self.kind == "r2c" else x

        def tf32(sl):
            return reference.transform(xr[sl], None if xi is None else xi[sl],
                                       self.ndim, self.kind, "tf32")
        return self._gap(i, tf32)
