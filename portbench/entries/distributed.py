"""One 1-D c2c signal split over the ranks of the process group:
`repro_torch.fft.plan(kind="c2c", n=N, mesh=..., placement="distributed")`
and `ExecutablePlan.execute` of each rank's contiguous shard, the
exchanges over the group's backend (NCCL between cards).

Each rank makes its shard from the seed and its rank. A signal of 2^32
points has no reference that fits one card, so `check` compares what a
float64 sum over every rank's shard can give exactly:

  rel_rms_err, rel_max_err   ``sampled_bins`` output bins drawn from the
                             seed, each the DFT's sum over the whole input
                             (`reference.sampled_bins`, partial sums added
                             over the ranks), over the root mean square bin
                             (Parseval: sum |x|^2)
  probe_err                  ``probes`` sums of the whole output against a
                             phase z^k, against the same sum from the input
                             side in closed form (`reference.probe_in`), over
                             sqrt(N sum |x|^2): every bin enters it, so a
                             fault anywhere in the output moves it
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from portbench import reference, work


class Driver:
    kind = "c2c"

    def __init__(self, ctx):
        import repro_torch.fft
        from torch.distributed.device_mesh import init_device_mesh

        cfg, tr = ctx.config, ctx.traffic
        (self.n,) = cfg["shape"]
        self.shard = self.n // ctx.world
        self.offset = ctx.rank * self.shard
        self.rank = ctx.rank
        self.in_bytes = work.in_bytes(self.kind, cfg)
        mesh = init_device_mesh(ctx.device.type, (ctx.world,),
                                mesh_dim_names=("data",))
        self.plan = repro_torch.fft.plan(kind="c2c", n=self.n, mesh=mesh,
                                         placement="distributed")
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed * ctx.world + ctx.rank)
        self.pool = [tuple(torch.randn(self.shard, generator=gen,
                                       device=ctx.device) for _ in range(2))
                     for _ in range(tr["pool"])]
        # the same bins and probes on every rank: drawn on the host
        host = torch.Generator().manual_seed(ctx.seed)
        self.bins = torch.randint(0, self.n, (tr["sampled_bins"],),
                                  generator=host).to(ctx.device)
        self.probes = torch.randint(0, self.n, (tr["probes"],),
                                    generator=host).tolist()

    def call(self, i):
        return self.plan.execute(*self.pool[i % len(self.pool)])

    @staticmethod
    def _summed(*parts) -> list:
        """Each part added over the ranks (float64 scalars or vectors)."""
        flat = torch.cat([p.double().reshape(-1) for p in parts])
        dist.all_reduce(flat)
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        return out

    def _input_side(self, x, precision):
        xr, xi = x
        sr, si = reference.sampled_bins(xr, xi, self.offset, self.n,
                                        self.bins, precision)
        q = [torch.stack(reference.probe_in(xr, xi, self.offset, self.n, m,
                                            precision)) for m in self.probes]
        return sr, si, torch.stack(q)

    def _numbers(self, x, yr, yi, q_out, precision) -> dict:
        """The three numbers for output bins ``yr``/``yi`` at ``self.bins``
        and output probes ``q_out`` (both summed over the ranks)."""
        xr, xi = x
        energy = sum(float((t[c:c + (1 << 24)].double() ** 2).sum())
                     for t in (xr, xi) for c in range(0, t.shape[0], 1 << 24))
        sr, si, q_in, (energy,) = self._summed(
            *self._input_side(x, "float64"),
            torch.tensor([energy], device=xr.device))
        gap = reference.Gap()
        gap.add(yr, yi, sr, si)
        numbers = gap.numbers(ref_mean_square=float(energy))
        probe = (q_out - q_in).norm(dim=1).max()
        numbers["probe_err"] = float(probe) / math.sqrt(self.n * energy)
        return numbers

    def check(self, i, out) -> dict:
        x = self.pool[i % len(self.pool)]
        yr, yi = out
        mine = (self.bins // self.shard) == self.rank
        at = self.bins[mine] - self.offset
        vr = torch.zeros(self.bins.shape, dtype=torch.float64,
                         device=yr.device)
        vi = torch.zeros_like(vr)
        vr[mine], vi[mine] = yr[at].double(), yi[at].double()
        q = torch.stack([torch.stack(reference.probe_out(
            yr, yi, self.offset, self.n, m)) for m in self.probes])
        vr, vi, q = self._summed(vr, vi, q)
        return self._numbers(x, vr, vi, q, "float64")

    def control(self, i) -> dict:
        """The reference in TF32 in the program's place: its sums at the
        bins and its probes, from the input side."""
        x = self.pool[i % len(self.pool)]
        cr, ci, cq = self._summed(*self._input_side(x, "tf32"))
        return self._numbers(x, cr, ci, cq, "float64")
