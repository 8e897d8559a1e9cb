"""`repro_torch.fft.plan` — cached executable plans (the `cufftPlanMany`
analogue).

The paper builds one batched CUFFT plan per block size and reuses it across
every map task; `plan(...)` resolves the full strategy up front (spec.py)
and returns a frozen `ExecutablePlan` from a process-level cache keyed on
the resolved spec, device included, and for the segmented and distributed
placements the `DeviceMesh` (SPMD: every rank of the mesh plans the same
global spec and executes on its own shard). A plan's build — uploading
its twiddle and DFT tables to the device, binding the kernel library and
creating the plan's CUDA stream — happens once: repeat `execute` calls on
the same spec rebuild nothing (`plan.build_counts["forward"]` stays at
1).

An `ExecutablePlan` carries:

  * the resolved `FftSpec` and the level-0/1/2 factorization of its
    longest axis pass (`plan.leaf`; the contiguous axis at half length
    for the real-input fast path), and for the distributed placement the
    cross-rank `DistPlan` (1-D) or `PencilPlan` (2-D/3-D; `plan.dist`);
  * the analytic cost model: `flops`, `gemm_macs` and `hbm_bytes` (the
    roofline byte counters `fft_hbm_bytes` / `rfft_hbm_bytes` and their
    N-D forms `fftn_hbm_bytes` / `rfftn_hbm_bytes`), and
    `collective_bytes` / `exposed_collective_bytes` and their per-leg
    forms for the exchanges;
  * `execute(xr, xi)` (c2c) / `execute_real(x)` (r2c) /
    `execute_inverse(yr, yi)` on the caller's current stream, and
    `execute_async(*operands, donate=)`, which stages host operands to the
    device on the plan's own stream and returns an `AsyncResult` without
    synchronising.

`fft2`, `ifft2`, `rfft2` and `irfft2` plan over the trailing two axes
(numpy.fft conventions) and execute through the cached plan.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from repro_torch.fft import executors
from repro_torch.fft import spec as spec_mod
from repro_torch.fft.spec import FftSpec
from repro_torch.kernels.fft import matfft as kmatfft
from repro_torch.kernels.fft import plan as kplan
from repro_torch.kernels.fft import stockham as kstockham
from repro_torch.spans import span

_F32 = 4  # bytes per planar float32 element

_PLAN_CACHE: dict = {}
# wisdom_hits counts tune=True plans whose knobs came from the wisdom file
# with zero measurements (fft/tuner.py); such a plan that is built anew is
# still a cache miss
_CACHE_INFO = {"hits": 0, "misses": 0, "wisdom_hits": 0}
# map-only jobs plan() from worker threads (core/pipeline): the
# check-then-act on the cache must be atomic or the first same-shaped
# blocks each build their own plan
_CACHE_LOCK = threading.Lock()


def _upload_tables(n: int, device: torch.device, impl: str) -> None:
    """Put every table a length-n c2c transform with leaf ``impl`` reads
    on ``device``."""
    p = kplan.make_plan(n)
    if p.levels == 1:
        if impl == "matfft":
            kmatfft.leaf_tables(n, device)
        elif impl == "stockham" and n > 1:
            kstockham.stockham_table(n, device)
        return
    _upload_tables(p.n1, device, impl)
    _upload_tables(p.n2, device, impl)
    kmatfft.outer_twiddle(p.n1, p.n2, device)


class AsyncResult:
    """A launched forward transform: device planes, the CUDA event that
    marks them complete (None on the CPU, where the work is already done)
    and the timing event recorded before the call's upload (None where
    there is none). `realize` is the only place the host waits.

    Once `realize` has returned, ``copy_s`` holds the host seconds it spent
    copying to host planes, the wait left out, and ``device_ms`` reads the
    device's time from the upload's start to the transform's end."""

    def __init__(self, yr: torch.Tensor, yi: torch.Tensor, event=None,
                 start=None):
        self.yr, self.yi, self.event, self.start = yr, yi, event, start
        self.copy_s: float | None = None

    @property
    def device_ms(self) -> float | None:
        """Device milliseconds from the upload's start to the transform's
        end; None before `realize` has waited or without a ``start``. Read
        on demand: `realize` itself pays no event query for it."""
        if self.start is None or self.copy_s is None:
            return None
        return self.start.elapsed_time(self.event)

    def realize(self) -> tuple[np.ndarray, np.ndarray]:
        """Wait for the transform and copy it to host numpy planes."""
        with span("repro_torch.fft.realize"):
            if self.event is not None:
                with span("repro_torch.fft.realize.wait"):
                    self.event.synchronize()
            t0 = time.perf_counter()
            with span("repro_torch.fft.realize.copy"):
                out = []
                for y in (self.yr, self.yi):
                    if y.device.type != "cpu":
                        host = torch.empty(y.shape, dtype=y.dtype,
                                           pin_memory=True)
                        y = host.copy_(y)
                    out.append(y.numpy())
            self.copy_s = time.perf_counter() - t0
        return out[0], out[1]


class ExecutablePlan:
    """Frozen plan: resolved strategy + cost model + built executables.

    Construct via `repro_torch.fft.plan(...)`, never directly — the
    module-level cache is what makes repeat plans free.
    """

    def __init__(self, spec: FftSpec, mesh=None):
        object.__setattr__(self, "_frozen", False)
        self.spec = spec
        self.mesh = mesh
        self.device = torch.device(spec.device)
        #: ranks over the mesh axes the plan splits its operand across
        self.num_devices = 1
        if mesh is not None:
            from repro_torch.core.fft import distributed
            self.num_devices = math.prod(distributed.axis_sizes(mesh,
                                                                spec.axes))
        # the r2c fast path packs n reals as n/2 complex points on the
        # contiguous axis (the N-D untangle runs after the other axes)
        self._fast_r2c = (spec.kind == "r2c" and spec.impl == "matfft"
                          and spec.shape[-1] >= 4
                          and spec.placement != "distributed")
        # the flop-halved r2c pencil: the packed half-width volume through
        # every pass and leg; set below where the grid admits it
        self._fast_r2c_pencil = False
        #: rank grid of a pencil plan (its axis k sharded over grid[k])
        self.grid = None
        #: cross-rank plan (distributed placement only)
        self.dist = None
        if spec.placement == "distributed":
            from repro_torch.core.fft import distributed
            chunks = None if spec.overlap == "off" else spec.overlap
            if spec.ndim == 1:
                self.dist = distributed.plan_distributed(
                    spec.n, self.num_devices,
                    natural_order=spec.natural_order, chunks=chunks)
                longest = max(self.dist.n1, self.dist.n2)
            else:
                self.grid = distributed.pencil_grid(
                    spec.shape, self.num_devices,
                    distributed.axis_sizes(mesh, spec.axes))
                eff_shape = spec.shape
                if spec.kind == "r2c":
                    half = distributed.pencil_r2c_half(spec.shape,
                                                       self.grid, spec.impl)
                    if half is not None:
                        self._fast_r2c_pencil = True
                        eff_shape = half
                self.dist = distributed.plan_pencil(
                    eff_shape, self.num_devices, grid=self.grid,
                    chunks=chunks)
                longest = max(eff_shape)
        else:
            # the contiguous axis dominates; halved by the r2c packing
            last = spec.shape[-1] // 2 if self._fast_r2c else spec.shape[-1]
            longest = max(last, *spec.shape[:-1], 1)
        #: level-0/1/2 factorization of the longest (per-rank) axis pass
        self.leaf = kplan.make_plan(longest)
        self._build_lock = threading.RLock()
        self._builds = {"forward": 0, "inverse": 0}
        self._fwd = None
        self._inv = None
        self._stream = None  # the plan's CUDA stream (execute_async)
        object.__setattr__(self, "_frozen", True)

    def __setattr__(self, name, value):
        if getattr(self, "_frozen", False) and not name.startswith("_"):
            raise AttributeError(
                f"ExecutablePlan is frozen; cannot set {name!r}")
        object.__setattr__(self, name, value)

    def __repr__(self):
        s = self.spec
        return (f"ExecutablePlan(kind={s.kind!r}, shape={s.shape}, "
                f"batch_shape={s.batch_shape}, placement={s.placement!r}, "
                f"layout={s.layout!r}, impl={s.impl!r}, device={s.device!r}, "
                f"levels={self.leaf.levels}, "
                f"fused_untangle={self.fused_untangle})")

    # ------------------------------------------------------------------
    # resolved-strategy views

    @property
    def kind(self) -> str:
        return self.spec.kind

    @property
    def n(self) -> int:
        return self.spec.n

    @property
    def shape(self) -> tuple:
        return self.spec.shape

    @property
    def ndim(self) -> int:
        return self.spec.ndim

    @property
    def batch_shape(self) -> tuple:
        return self.spec.batch_shape

    @property
    def placement(self) -> str:
        return self.spec.placement

    @property
    def operand_shape(self) -> tuple:
        """This rank's operand: the global (*batch_shape, *shape) split
        along dim 0 over the mesh ranks ((rows/D, *shape) segmented, (n/D,)
        1-D distributed); a pencil's input block, axis k over grid[k]
        (`core.fft.distributed.pencil_shard`)."""
        shape = self.spec.operand_shape
        if self.grid is not None:
            return (*(d // g for d, g in zip(shape, self.grid)),
                    *shape[len(self.grid):])
        return (shape[0] // self.num_devices, *shape[1:])

    @property
    def output_shape(self) -> tuple:
        """This rank's forward output: the operand's shape (the last axis
        one-sided for r2c); a c2c pencil's output block is the grid
        rotated one axis right, and an r2c pencil returns the whole
        global one-sided spectrum on every rank."""
        s = self.spec
        if s.kind == "r2c":
            shape = (self.spec.operand_shape if self.grid is not None
                     else self.operand_shape)
            return (*shape[:-1], s.shape[-1] // 2 + 1)
        if self.grid is not None:
            return (s.shape[0], *(d // g for d, g in zip(s.shape[1:],
                                                         self.grid)))
        return self.operand_shape

    @property
    def levels(self) -> int:
        return self.leaf.levels

    @property
    def fused_untangle(self) -> bool:
        """True when the r2c untangle runs fused in one leaf kernel (K3):
        a 1-D plan whose n/2 is one leaf, n <= 2*MAX_LEAF. False for
        longer r2c plans, where it runs as torch ops after the half-length
        transform, for N-D plans (the untangle runs after the leading
        axes' passes), and for every c2c plan."""
        return (self._fast_r2c and self.spec.ndim == 1
                and self.leaf.levels == 1)

    # ------------------------------------------------------------------
    # analytic cost model (roofline numerators)

    @property
    def flops_per_row(self) -> float:
        """Algorithmic FLOPs per batch row (the 5 n log2 n convention).

        N-D is a sum over axis passes; the r2c fast path halves the
        working width after the contiguous-axis pass and adds the O(N/2)
        untangle (~10 real ops a bin)."""
        s = self.spec
        n = s.n
        if n <= 1:
            return 0.0
        if not (self._fast_r2c or self._fast_r2c_pencil):
            return 5.0 * n * math.log2(n)
        m = s.shape[-1] // 2  # >= 2
        if s.ndim == 1:
            return 5.0 * m * math.log2(m) + 10.0 * m
        half_n = n // 2
        f = 10.0 * half_n + (half_n // m) * 5.0 * m * math.log2(m)
        for ax_len in s.shape[:-1]:
            f += (half_n // ax_len) * 5.0 * ax_len * math.log2(ax_len)
        return f

    @property
    def flops(self) -> float:
        return self.spec.rows * self.flops_per_row

    @property
    def gemm_macs_per_row(self) -> float:
        """Real MACs the reference's matrix formulation issues per batch
        row (`FftPlan.gemm_macs`; not the port's radix leaf). N-D: the
        sum over axis passes."""
        s = self.spec
        if s.ndim == 1 and self.dist is not None:
            # pass 1: n2 length-n1 transforms; pass 2: n1 length-n2
            d = self.dist
            return (d.n2 * kplan.make_plan(d.n1).gemm_macs
                    + d.n1 * kplan.make_plan(d.n2).gemm_macs)
        if s.ndim == 1:
            return self.leaf.gemm_macs
        # per-axis passes; the same for local, segmented and pencil plans
        fast = self._fast_r2c or self._fast_r2c_pencil
        width = s.n // 2 if fast else s.n
        last = s.shape[-1] // 2 if fast else s.shape[-1]
        macs = (width // last) * kplan.make_plan(last).gemm_macs
        for ax_len in s.shape[:-1]:
            macs += (width // ax_len) * kplan.make_plan(ax_len).gemm_macs
        return macs

    @property
    def gemm_macs(self) -> float:
        return self.spec.rows * self.gemm_macs_per_row

    @property
    def hbm_bytes_per_row(self) -> int:
        """Planar-f32 payload device-memory bytes per batch row (tables
        excluded), over every rank."""
        s = self.spec
        if self.dist is not None and s.ndim > 1:
            # the pencil: ndim local passes, and each of the ndim-1 legs'
            # buffers landing in device memory (one round trip a leg)
            per_pass = 2 * 2 * _F32 * s.n
            legs = s.ndim - 1
            m1 = s.shape[-1] // 2 + 1
            if self._fast_r2c_pencil:
                # every pass and leg moves the packed HALF volume; the
                # global untangle re-reads the half planes and writes the
                # m+1-bin one-sided spectrum
                return ((s.ndim + legs) * (per_pass // 2)
                        + 2 * _F32 * (s.n // 2)
                        + 2 * _F32 * (s.n // s.shape[-1]) * m1)
            bytes_ = (s.ndim + legs) * per_pass
            if s.kind == "r2c":
                # the c2c pencil, then the one-sided slice
                bytes_ += 2 * _F32 * (s.n // s.shape[-1]) * m1
            return bytes_
        if self.dist is not None:
            # two local passes, each reading and writing 2 planes, the
            # exchanges' buffers landing in device memory (one round trip
            # each) and, unfused, the twiddle's own round trip
            per_pass = 2 * 2 * _F32 * s.n
            bytes_ = (2 + self.dist.n_exchanges) * per_pass
            return bytes_ + (0 if s.fuse_twiddle else per_pass)
        if self._fast_r2c:
            return kplan.rfftn_hbm_bytes(s.shape)
        c2c = kplan.fftn_hbm_bytes(s.shape, s.layout)
        if s.kind == "r2c":
            # full complex transform + sliced one-sided write
            return (c2c + 2 * _F32 * (s.n // s.shape[-1])
                    * (s.shape[-1] // 2 + 1))
        return c2c

    @property
    def hbm_bytes(self) -> int:
        return self.spec.rows * self.hbm_bytes_per_row

    @property
    def collective_bytes(self) -> int:
        """Planar payload all ranks send to each other (distributed
        placement only; transposed-out plans skip exchange #3)."""
        if self.dist is None:
            return 0
        return self.dist.d * self.dist.collective_bytes_per_device

    @property
    def exposed_collective_bytes(self) -> int:
        """Collective bytes the overlapped engine cannot hide behind the
        local FFTs (its fill/drain slab an exchange); all of them with
        overlap "off"."""
        if self.dist is None:
            return 0
        return self.dist.d * self.dist.exposed_collective_bytes_per_device

    @property
    def per_leg_collective_bytes(self) -> tuple:
        """Payload all ranks send in each exchange leg, in leg order (a
        pencil's axis nd-2 first; the 1-D engine's three exchanges); sums
        to `collective_bytes`; () for other placements."""
        if self.dist is None:
            return ()
        return tuple(self.dist.d * b
                     for b in self.dist.per_leg_bytes_per_device)

    @property
    def per_leg_exposed_collective_bytes(self) -> tuple:
        """`exposed_collective_bytes` leg by leg."""
        if self.dist is None:
            return ()
        return tuple(self.dist.d * b
                     for b in self.dist.per_leg_exposed_bytes_per_device)

    # ------------------------------------------------------------------
    # builds

    @property
    def build_counts(self) -> dict:
        return dict(self._builds)

    def _forward(self):
        if self._fwd is None:
            with self._build_lock:
                if self._fwd is None:
                    self._fwd = self._build_forward()
        return self._fwd

    def _build_forward(self):
        s = self.spec
        dev = self.device
        if self.mesh is not None and self.mesh.get_coordinate() is None:
            raise ValueError(
                f"rank {torch.distributed.get_rank()} is not part of this "
                f"plan's mesh (a rank left out of a shrunk mesh): it holds "
                f"no shard and runs nothing")
        if self.dist is not None and s.ndim == 1:
            # both passes' tables, and the twiddle's (fused or not)
            for length in {self.dist.n1, self.dist.n2}:
                _upload_tables(length, dev, s.impl)
            kmatfft.global_twiddle_tables(s.n, dev)
        elif self.dist is not None:
            # each axis pass at its (packed) length; the global untangle's
            # packing twiddle
            if s.impl in ("matfft", "stockham"):
                for length in set(self.dist.shape):
                    _upload_tables(length, dev, s.impl)
            if self._fast_r2c_pencil:
                kmatfft.rfft_twiddle(s.shape[-1], dev)
        elif s.impl in ("matfft", "stockham"):
            # every axis pass reads the tables of its length; the fast r2c
            # path runs the contiguous axis at n/2 (K3, or the c2c path
            # past one leaf) and untangles with the packing twiddle, with
            # which irfft re-entangles
            last = s.shape[-1]
            for length in {*s.shape[:-1],
                           last // 2 if self._fast_r2c else last}:
                _upload_tables(length, dev, s.impl)
            if self._fast_r2c:
                kmatfft.rfft_twiddle(last, dev)
        if dev.type == "cuda":
            if s.impl == "matfft":
                kmatfft._lib()  # build (first use) and bind the kernels
            elif s.impl == "stockham":
                kstockham._lib()
            self._stream = torch.cuda.Stream(dev)
        self._builds["forward"] += 1
        if self.dist is not None and s.ndim > 1:
            return self._build_pencil()
        if self.dist is not None:
            from repro_torch.core.fft.distributed import build_distributed
            return build_distributed(
                s.n, self.mesh, s.axes, impl=s.impl,
                natural_order=s.natural_order, fuse_twiddle=s.fuse_twiddle,
                layout=s.layout,
                overlap=None if s.overlap == "off" else s.overlap)
        # local, or a segmented rank's map task: the transform of its rows
        from repro_torch.core.fft.segmented import build_segmented
        return build_segmented(s.kind, s.shape, impl=s.impl, layout=s.layout)

    def _build_pencil(self):
        """The 2-D/3-D pencil: c2c maps this rank's input block to its
        output block; r2c maps its real input block to the GLOBAL one-sided
        spectrum, on every rank: the untangle pairs bin k with the bin
        flipped along every axis, which another rank holds, so the packed
        half spectrum is gathered first and ONE N-D untangle runs on it,
        where local rfftn runs it (bitwise equal to local rfftn)."""
        from repro_torch.core.fft import distributed
        s = self.spec
        kw = dict(impl=s.impl, layout=s.layout,
                  overlap=None if s.overlap == "off" else s.overlap)
        if s.kind == "c2c":
            return distributed.build_pencil(s.shape, self.mesh, s.axes, **kw)
        gather = distributed.build_gather(self.mesh, s.axes, self.dist.shape)
        if self._fast_r2c_pencil:
            half = distributed.build_pencil_r2c(s.shape, self.mesh, s.axes,
                                                **kw)

            def forward(x):
                zr, zi = gather(*half(x))
                vr, vi = kmatfft.rfft_twiddle(s.shape[-1], x.device)
                return executors._untangle_nd(zr, zi, vr, vi, s.ndim)
            return forward
        pencil = distributed.build_pencil(s.shape, self.mesh, s.axes, **kw)
        m1 = s.shape[-1] // 2 + 1

        def forward(x):
            # the grid cannot split the half width, or the impl has no
            # packed pass: the c2c pencil, then the one-sided slice
            yr, yi = gather(*pencil(x, torch.zeros_like(x)))
            return yr[..., :m1].contiguous(), yi[..., :m1].contiguous()
        return forward

    def _inverse(self):
        if self._inv is None:
            with self._build_lock:
                if self._inv is None:
                    fwd = self._forward()
                    s = self.spec

                    if s.kind == "r2c" and s.placement != "local":
                        raise NotImplementedError(
                            f"execute_inverse for r2c plans is local-only, "
                            f"got placement={s.placement!r}")
                    if self.dist is not None and not s.natural_order:
                        raise NotImplementedError(
                            "execute_inverse needs natural_order=True: the "
                            "transposed-out forward returns o1-major block "
                            "order, so the conjugation identity would "
                            "invert a permuted spectrum; plan the inverse "
                            "with natural_order=True")
                    if s.kind == "r2c":
                        def inverse(yr, yi):
                            return executors.irfftn(
                                yr, yi, s.shape, impl=s.impl,
                                layout=s.layout)
                    elif self.grid is not None:
                        # the pencil backwards: output layout in, input
                        # layout out (monolithic exchanges)
                        from repro_torch.core.fft import distributed
                        rev = distributed.build_pencil_reverse(
                            s.shape, self.mesh, s.axes, impl=s.impl,
                            layout=s.layout)

                        def inverse(yr, yi):
                            ar, ai = rev(yr, -yi)
                            return ar / s.n, -ai / s.n
                    else:
                        def inverse(yr, yi):
                            # conjugation identity on the forward
                            # transform; s.n is every point, the N-D scale
                            ar, ai = fwd(yr, -yi)
                            return ar / s.n, -ai / s.n

                    self._builds["inverse"] += 1
                    self._inv = inverse
        return self._inv

    # ------------------------------------------------------------------

    def _operand(self, x, what: str, shape=None) -> torch.Tensor:
        x = torch.as_tensor(x)
        shape = self.operand_shape if shape is None else shape
        if tuple(x.shape) != shape:
            raise ValueError(
                f"{what}: plan was built for shape {shape} "
                f"(batch_shape={self.spec.batch_shape}, "
                f"shape={self.spec.shape}), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: operands must be float32, got "
                            f"{x.dtype}")
        return x

    def execute(self, xr, xi):
        """Forward c2c transform of planar (*batch_shape, *shape) float32
        operands, on the caller's current stream. Returns planes on the
        plan's device."""
        with span("repro_torch.fft.execute"):
            if self.spec.kind != "c2c":
                raise ValueError(
                    "execute() is for kind='c2c' plans; use execute_real(x) "
                    "on this r2c plan")
            xr = self._operand(xr, "execute").to(self.device)
            xi = self._operand(xi, "execute").to(self.device)
            return self._forward()(xr, xi)

    def execute_real(self, x):
        """Forward r2c transform: real (*batch_shape, *shape) float32 ->
        planar one-sided (*batch_shape, *shape[:-1], shape[-1]//2 + 1)
        spectrum, on the caller's current stream and the plan's device."""
        with span("repro_torch.fft.execute_real"):
            if self.spec.kind != "r2c":
                raise ValueError(
                    "execute_real() is for kind='r2c' plans; use "
                    "execute(xr, xi) on this c2c plan")
            x = self._operand(x, "execute_real").to(self.device)
            return self._forward()(x)

    def execute_inverse(self, yr, yi):
        """Inverse transform. c2c: planar spectrum -> planar signal, both
        (*batch_shape, *shape). r2c: one-sided (*batch_shape, *shape[:-1],
        shape[-1]//2 + 1) spectrum -> real (*batch_shape, *shape)
        signal."""
        with span("repro_torch.fft.execute_inverse"):
            shape = self.output_shape
            yr = self._operand(yr, "execute_inverse", shape).to(self.device)
            yi = self._operand(yi, "execute_inverse", shape).to(self.device)
            return self._inverse()(yr, yi)

    def execute_async(self, *operands, donate: bool = False) -> AsyncResult:
        """Launch the forward transform of host operands WITHOUT waiting
        for it. Operands: ``(xr, xi)`` for c2c plans, ``(x,)`` for r2c.

        On CUDA the operands are copied to the device on the plan's own
        stream (``non_blocking``: from pinned host memory the copy is
        asynchronous), the kernels are launched there, and an event is
        recorded. The returned `AsyncResult` realizes to host planes.
        ``donate=True`` hands the operands to the launch: the caller must
        not write them until the result is realized (the stream executor's
        staging pool releases them only then). ``donate=False`` returns
        after the operands have been copied, so they may be reused at once.
        """
        with span("repro_torch.fft.execute_async"):
            nargs = 1 if self.spec.kind == "r2c" else 2
            if len(operands) != nargs:
                raise ValueError(
                    f"execute_async on a {self.spec.kind!r} plan takes "
                    f"{nargs} operand(s), got {len(operands)}")
            ops = [self._operand(x, "execute_async") for x in operands]
            fwd = self._forward()
            if self.device.type == "cpu":
                return AsyncResult(*fwd(*ops))
            with torch.cuda.stream(self._stream):
                # timing events: `realize` reads the call's device time
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._stream)
                staged_ops = [x.to(self.device, non_blocking=True)
                              for x in ops]
                if not donate:
                    staged = torch.cuda.Event()
                    staged.record(self._stream)
                yr, yi = fwd(*staged_ops)
                done = torch.cuda.Event(enable_timing=True)
                done.record(self._stream)
            if not donate:
                staged.synchronize()
            return AsyncResult(yr, yi, done, start)


# ---------------------------------------------------------------------------
# the facade


def plan(kind: str = "c2c", *, n: int | None = None, shape=None,
         batch_shape=(), mesh=None, placement: str = "auto",
         layout: str = "zero_copy", impl: str = "matfft",
         precision: str = "f32", device=None, axes=None, natural_order: bool = True, fuse_twiddle: bool = False,
         overlap="auto", r2c_axis: int = -1, fallback: str = "error",
         verify: str = "off", tune: bool = False, wisdom_path=None,
         tune_config=None, store=None, work_dir=None,
         budget_bytes: int | None = None, job_config=None):
    """Resolve a transform spec and return the cached `ExecutablePlan`, or
    for ``placement="out_of_core"`` a new `OutOfCorePlan`.

    Args:
      kind: "c2c" (planar complex) or "r2c" (real input, one-sided
        output; `execute_real`).
      n: 1-D transform length — sugar for ``shape=(n,)``; pass exactly one
        of ``n``/``shape`` (power-of-two lengths; the real length for
        r2c).
      shape: N-D transform shape over the TRAILING operand axes, 1 to 3
        axes, e.g. ``shape=(n0, n1)`` for a 2-D image FFT. The contiguous
        (last) axis runs the level-0/1/2 four-step (up to MAX_LOCAL_N);
        earlier axes one column-kernel pass each up to MAX_LEAF, a
        level-1 transform between two transposes up to MAX_EARLIER_AXIS.
        Scalar ``n`` and the equivalent 1-tuple give the SAME plan.
      batch_shape: leading batch dims of the GLOBAL operand; () for one
        signal (required for placement="distributed").
      mesh: a `torch.distributed.device_mesh.DeviceMesh` with named dims
        for the segmented and distributed placements. Every rank of the
        mesh calls `plan` with the same arguments and executes on its own
        shard of dim 0 (`core.fft.distributed.local_shard`).
      placement: "auto" (the heuristic of `spec.resolve_placement`),
        "local", "segmented" (the batch split over the mesh ranks, each
        rank transforming its rows, no collectives), "distributed" (ONE
        1-D c2c signal, the cross-rank four-step, three exchanges; or ONE
        2-D/3-D c2c or r2c volume, the pencil, ndim-1 exchanges, each rank
        holding its `pencil_shard`; core/fft/distributed.py) or
        "out_of_core" (one 1-D c2c signal
        whose operand lives in ``store``, streamed through two bounded
        passes of cached local plans; core/fft/outofcore.py).
      layout: "zero_copy" (default) or "copy" (the measured baseline; for
        N-D the naive transpose-per-axis path).
      impl: leaf kernel: "matfft" (K1/K2, and K3 for r2c), "stockham"
        (K4; r2c then runs the full complex transform, sliced) or "ref"
        (torch.fft).
      precision: "f32".
      device: "cuda" (the default without a mesh; raises when no card is
        present) or "cpu", which runs the kernels' plain PyTorch versions.
        With a mesh it defaults to the mesh's device type, and another is
        a ValueError.
      axes: the mesh dims to flatten (None: every dim), row-major in the
        order given.
      natural_order, fuse_twiddle: distributed options: False skips
        exchange #3 and returns the o1-major TRANSPOSED_OUT order; True
        fuses pass 1's twiddle into the leaf kernel's store.
      overlap: the distributed exchange engine: "off" (one
        `all_to_all_single` a plane and exchange), an int (that many
        slabs, each exchanged as `batch_isend_irecv` rounds behind the
        local FFTs; it must divide n1/D and n2/D, or for a pencil every
        leg's slab width shape[k+1]/grid[k]) or "auto".
      r2c_axis: the transform axis that carries the real-to-complex
        halving; only the contiguous axis (-1) is supported, anything
        else is a plan-time ValueError.
      verify: ABFT mode for consumers that run the plan's invariant checks:
        "off", "parseval" or "abft". Verified and unverified plans are
        distinct cache entries.
      fallback: "error" (default) raises when the requested strategy
        cannot be built; "degrade" re-plans instead when the mesh has lost
        ranks (core/resilience/meshstate.py) or the mesh-bound strategy is
        unsatisfiable: first on the largest healthy power-of-two sub-mesh
        (`meshstate.shrunk_mesh`, at the requested placement, then
        "auto"), then locally. Every downgrade drops the mesh's cached
        plans (`invalidate_mesh`) and records a "plan_downgrade" event.
        In SPMD every rank must mark the same losses and call `plan`
        together (building the sub-mesh's groups is collective). A rank
        left out of the sub-mesh gets the same plan but holds no shard:
        executing it raises ValueError. The degraded LOCAL plan takes the
        GLOBAL operand, as the mesh-free plan always does: a caller that
        passes its shard gets a shape error, not a wrong answer.
      tune: measure instead of model (`repro_torch.fft.tuner`): time the
        candidate layouts and overlap chunk counts at a
        representative shape, resolve the winner's knobs BEFORE the cache
        key (a plan with the same knobs spelled out is the same plan), and
        record the decision as wisdom keyed on the spec, the mesh's
        fingerprint and the card. A wisdom hit measures nothing
        (`cache_info()["wisdom_hits"]`). Out of core it picks
        ``panel_scale`` (`tuner.tune_out_of_core`). On a mesh every rank
        gets the same knobs.
      wisdom_path: the wisdom file (default
        ~/.cache/repro_torch_fft/wisdom.json); tune=True only.
      tune_config: a `tuner.TuneConfig` (seed, repeats, timer, measurer,
        model rates); tune=True only.
      store, work_dir, budget_bytes, job_config: out-of-core only — the
        `BlockStore` holding the operand, the directory for tiles,
        manifests and output, the host working-set cap in bytes, and the
        streamed passes' `JobConfig` (None: the plan's default).

    Same resolved spec (and mesh) -> the SAME plan object, with its
    tables already on the device. Out-of-core plans carry live store state
    and are never cached; the per-pass plans they launch are.
    """
    if fallback not in ("error", "degrade"):
        raise ValueError(
            f"fallback must be 'error' or 'degrade', got {fallback!r}")
    if placement == "out_of_core":
        if mesh is not None:
            raise ValueError(
                "placement='out_of_core' streams through storage on one "
                "host; it takes no mesh=")
        return _plan_out_of_core(kind, n, shape, batch_shape, impl,
                                 device or "cuda", verify, store, work_dir,
                                 budget_bytes, job_config, tune, wisdom_path,
                                 tune_config)
    if store is not None or work_dir is not None or budget_bytes is not None:
        raise ValueError(
            "store=/work_dir=/budget_bytes= apply only to "
            "placement='out_of_core'")
    if mesh is not None:
        if device is None:
            device = mesh.device_type
        elif torch.device(device).type != mesh.device_type:
            raise ValueError(f"device={device!r} disagrees with the mesh's "
                             f"device type {mesh.device_type!r}")

    def degrade(reason: str):
        """The degradation chain: the shrunk healthy mesh, then local.

        Returns the downgraded plan, or None when every candidate fails
        (the caller raises its own error). The mesh's cached plans are
        dropped first: they hold collectives over ranks that no longer
        answer.
        """
        from repro_torch.core.resilience import meshstate
        from repro_torch.core.resilience.events import record_event
        dropped = invalidate_mesh(mesh)
        sub = meshstate.shrunk_mesh(mesh)
        candidates = []
        if sub is not None:
            candidates.append((sub, placement))
            if placement not in ("auto", "local"):
                candidates.append((sub, "auto"))
        candidates.append((None, "local"))
        for sub_mesh, sub_placement in candidates:
            try:
                p = plan(kind=kind, n=n, shape=shape,
                         batch_shape=batch_shape, mesh=sub_mesh,
                         placement=sub_placement, layout=layout, impl=impl,
                         precision=precision, device=device, axes=None,
                         natural_order=natural_order,
                         fuse_twiddle=fuse_twiddle, overlap=overlap,
                         r2c_axis=r2c_axis, fallback="error", verify=verify)
            except (ValueError, NotImplementedError):
                continue
            record_event(
                "plan_downgrade", reason=reason,
                requested_placement=placement,
                resolved_placement=p.placement,
                from_devices=int(mesh.mesh.numel()),
                to_devices=(int(sub_mesh.mesh.numel())
                            if sub_mesh is not None else 0),
                epoch=meshstate.epoch(), plans_invalidated=dropped)
            return p
        return None

    if fallback == "degrade" and mesh is not None:
        from repro_torch.core.resilience import meshstate
        if not meshstate.mesh_healthy(mesh):
            p = degrade("mesh_degraded")
            if p is not None:
                return p
            raise RuntimeError(
                f"fallback='degrade': no viable plan for a mesh with "
                f"{len(meshstate.healthy_devices(mesh))}/"
                f"{mesh.mesh.numel()} healthy ranks")

    num_devices = sizes = None
    if mesh is not None:
        from repro_torch.core.fft import distributed
        axes = distributed.mesh_axes(mesh, axes)
        sizes = distributed.axis_sizes(mesh, axes)
        num_devices = math.prod(sizes)
    elif axes is not None:
        raise ValueError("axes= requires mesh=")
    if tune:
        # measure, then plan: the winner's knobs resolve into the spec
        # before the cache key
        from repro_torch.fft import tuner
        knobs, report = tuner.tune(
            kind=kind, n=n, shape=shape, batch_shape=batch_shape, mesh=mesh,
            axes=axes, num_devices=num_devices, axis_sizes=sizes,
            placement=placement, layout=layout, impl=impl,
            precision=precision, device=device or "cuda",
            natural_order=natural_order,
            fuse_twiddle=fuse_twiddle, overlap=overlap, r2c_axis=r2c_axis,
            verify=verify, wisdom_path=wisdom_path, config=tune_config)
        layout = knobs.get("layout", layout)
        overlap = knobs.get("overlap", overlap)
        if report.wisdom_hit:
            with _CACHE_LOCK:
                _CACHE_INFO["wisdom_hits"] += 1
    try:
        resolved = spec_mod.resolve(
            kind=kind, n=n, shape=shape, batch_shape=batch_shape,
            placement=placement, layout=layout, impl=impl,
            precision=precision, device=device or "cuda",
            r2c_axis=r2c_axis, verify=verify, num_devices=num_devices,
            axes=axes, natural_order=natural_order,
            fuse_twiddle=fuse_twiddle, overlap=overlap, axis_sizes=sizes)
    except ValueError:
        # a mesh-bound strategy that cannot be satisfied (too few ranks for
        # the split, say): degrade walks the same chain instead of raising;
        # a mesh-free failure is a spec error, with nothing to degrade to
        if fallback == "degrade" and mesh is not None:
            p = degrade("resolve_failed")
            if p is not None:
                return p
        raise
    # local plans do not touch the mesh: keyed mesh-free, so the same spec
    # planned with and without a mesh is one plan
    key = (resolved, None if resolved.placement == "local" else mesh)
    with _CACHE_LOCK:
        cached = _PLAN_CACHE.get(key)
        if cached is not None:
            _CACHE_INFO["hits"] += 1
            return cached
        _CACHE_INFO["misses"] += 1
        p = ExecutablePlan(resolved, key[1])
        _PLAN_CACHE[key] = p
        return p


def _plan_out_of_core(kind, n, shape, batch_shape, impl, device, verify,
                      store, work_dir, budget_bytes, job_config, tune=False,
                      wisdom_path=None, tune_config=None):
    """Validate the out-of-core arguments and bind the plan to ``store``;
    with ``tune``, the tuner picks its panel height."""
    if kind != "c2c":
        raise ValueError(
            "placement='out_of_core' streams the four-step c2c "
            "decomposition; run real captures as packed c2c")
    if shape is not None:
        shape_t = (shape,) if isinstance(shape, int) else tuple(shape)
        if n is not None or len(shape_t) != 1:
            raise ValueError(
                f"placement='out_of_core' transforms ONE 1-D signal; "
                f"pass n= (or a 1-tuple shape), got shape={shape}")
        n = int(shape_t[0])
    if n is None:
        raise ValueError("placement='out_of_core' requires n=")
    if batch_shape not in ((), None):
        raise ValueError(
            f"placement='out_of_core' takes no batch_shape, got "
            f"{batch_shape}; the panel batching is internal")
    if impl not in spec_mod.IMPLS:
        raise ValueError(
            f"unknown fft impl {impl!r}; expected one of {spec_mod.IMPLS}")
    if store is None or work_dir is None or budget_bytes is None:
        raise ValueError(
            "placement='out_of_core' requires store= (the BlockStore "
            "holding the operand), work_dir= (tiles/manifests/output), "
            "and budget_bytes= (the host working-set cap)")
    from repro_torch.core.fft.outofcore import plan_out_of_core
    panel_scale = 1
    if tune:
        from repro_torch.fft import tuner
        panel_scale, rep = tuner.tune_out_of_core(
            int(n), int(budget_bytes), impl=impl,
            block_bytes=getattr(store, "block_bytes", None),
            wisdom_path=wisdom_path, config=tune_config, device=device)
        if rep.wisdom_hit:
            with _CACHE_LOCK:
                _CACHE_INFO["wisdom_hits"] += 1
    return plan_out_of_core(int(n), store, work_dir, int(budget_bytes),
                            impl=impl, config=job_config, verify=verify,
                            device=device, panel_scale=panel_scale)


# ---------------------------------------------------------------------------
# 2-D convenience wrappers (numpy.fft.fft2/rfft2 conventions): plan over the
# trailing two axes, execute through the cached plan


def _check_2d(a, what: str) -> None:
    # numpy.fft.fft2/rfft2 raise for <2-D input; silently planning a 1-D
    # transform here would hand back a wrong-dimensionality spectrum
    if a.ndim < 2:
        raise ValueError(
            f"{what} transforms the trailing TWO axes; got a "
            f"{a.ndim}-D operand of shape {tuple(a.shape)} — use the 1-D "
            f"plan (n=...) for single-axis transforms")


def fft2(xr, xi, **kw):
    """Forward 2-D FFT over the trailing two axes of planar float32
    tensors. ``kw`` passes through to `plan` (device=, layout=, impl=);
    repeat calls with the same shapes hit the plan cache."""
    _check_2d(xr, "fft2")
    p = plan(kind="c2c", shape=tuple(xr.shape[-2:]),
             batch_shape=tuple(xr.shape[:-2]), **kw)
    return p.execute(xr, xi)


def ifft2(yr, yi, **kw):
    """Inverse 2-D FFT over the trailing two axes (planar)."""
    _check_2d(yr, "ifft2")
    p = plan(kind="c2c", shape=tuple(yr.shape[-2:]),
             batch_shape=tuple(yr.shape[:-2]), **kw)
    return p.execute_inverse(yr, yi)


def rfft2(x, **kw):
    """Real-input 2-D FFT: (*batch, n0, n1) real -> planar one-sided
    (*batch, n0, n1//2 + 1) spectrum (numpy.fft.rfft2 convention)."""
    _check_2d(x, "rfft2")
    p = plan(kind="r2c", shape=tuple(x.shape[-2:]),
             batch_shape=tuple(x.shape[:-2]), **kw)
    return p.execute_real(x)


def irfft2(yr, yi, shape=None, **kw):
    """Inverse of rfft2: one-sided spectrum -> real (*batch, n0, n1).

    ``shape`` is the real-image shape (n0, n1); the default reconstructs
    the even length 2*(yr.shape[-1] - 1) like numpy.fft.irfft2.
    """
    _check_2d(yr, "irfft2")
    if shape is None:
        shape = (yr.shape[-2], 2 * (yr.shape[-1] - 1))
    p = plan(kind="r2c", shape=tuple(shape),
             batch_shape=tuple(yr.shape[:-2]), **kw)
    return p.execute_inverse(yr, yi)


def cache_info() -> dict:
    """Process-level plan-cache stats: {entries, hits, misses,
    wisdom_hits}. ``wisdom_hits`` counts tune=True plans whose knobs came
    from the wisdom file with zero measurements; a wisdom hit that builds
    a new plan is a miss as well."""
    with _CACHE_LOCK:
        return {**_CACHE_INFO, "entries": len(_PLAN_CACHE)}


def invalidate_mesh(mesh) -> int:
    """Drop every cached plan keyed on ``mesh``; returns how many. Local
    plans (keyed mesh-free) are untouched."""
    if mesh is None:
        return 0
    with _CACHE_LOCK:
        stale = [k for k in _PLAN_CACHE if k[1] is not None and k[1] == mesh]
        for k in stale:
            del _PLAN_CACHE[k]
    return len(stale)


def clear_plan_cache() -> None:
    """Drop every cached plan and reset the cache counters."""
    with _CACHE_LOCK:
        _PLAN_CACHE.clear()
        for k in _CACHE_INFO:
            _CACHE_INFO[k] = 0
