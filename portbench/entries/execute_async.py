"""Local c2c transforms of planar operands in pinned host memory, through
`ExecutablePlan.execute_async` and `AsyncResult.realize`: the paper's map
task between its read and its write, host to device, the transform, and
device to host.

Operands are made on the device from the seed, as `execute` makes them,
and kept in pinned host memory. A call is issued with ``donate=True``, as
the stream executor issues its staged blocks (the pool is never written),
so the host-to-device copy of one call runs while the host realizes the
call before it. A call completes when `realize` has handed back its host
planes; those are what `check` holds to the reference.
"""

from __future__ import annotations

import torch

from portbench.entries import execute


class Driver(execute.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        pinned = ctx.device.type == "cuda"
        self.pool = [tuple(torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=pinned).copy_(t) for t in x)
                     for x in self.pool]

    def call(self, i):
        return self.plan.execute_async(*self.pool[i % len(self.pool)],
                                       donate=True)

    @staticmethod
    def complete(out):
        return out.realize()

    def operand_of(self, i):
        return tuple(t.to(self.device)
                     for t in self.pool[i % len(self.pool)])

    def check(self, i, out) -> dict:
        return super().check(i, tuple(torch.from_numpy(a).to(self.device)
                                      for a in out))
