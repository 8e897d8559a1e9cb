"""`repro_torch.fft.plan` — cached executable plans (the `cufftPlanMany`
analogue).

The paper builds one batched CUFFT plan per block size and reuses it across
every map task; `plan(...)` resolves the full strategy up front (spec.py)
and returns a frozen `ExecutablePlan` from a process-level cache keyed on
the resolved spec, device included. A plan's build — uploading its twiddle
and DFT tables to the device, binding the kernel library and creating the
plan's CUDA stream — happens once: repeat `execute` calls on the same spec
rebuild nothing (`plan.build_counts["forward"]` stays at 1).

An `ExecutablePlan` carries:

  * the resolved `FftSpec` and the level-0/1/2 factorization (`plan.leaf`);
  * the analytic cost model: `flops`, `gemm_macs` and `hbm_bytes` (the
    roofline byte counter `fft_hbm_bytes`);
  * `execute(xr, xi)` / `execute_inverse(yr, yi)` on the caller's current
    stream, and `execute_async(xr, xi, donate=)`, which stages host
    operands to the device on the plan's own stream and returns an
    `AsyncResult` without synchronising.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from repro_torch.fft import executors
from repro_torch.fft import spec as spec_mod
from repro_torch.fft.spec import FftSpec
from repro_torch.kernels.fft import matfft as kmatfft
from repro_torch.kernels.fft import plan as kplan

_PLAN_CACHE: dict = {}
_CACHE_INFO = {"hits": 0, "misses": 0}
# map-only jobs plan() from worker threads (core/pipeline): the
# check-then-act on the cache must be atomic or the first same-shaped
# blocks each build their own plan
_CACHE_LOCK = threading.Lock()


def _upload_tables(n: int, device: torch.device) -> None:
    """Put every table a length-n matfft transform reads on ``device``."""
    p = kplan.make_plan(n)
    if p.levels == 1:
        kmatfft.leaf_tables(n, device)
        return
    _upload_tables(p.n1, device)
    _upload_tables(p.n2, device)
    kmatfft.outer_twiddle(p.n1, p.n2, device)


class AsyncResult:
    """A launched forward transform: device planes, and the CUDA event that
    marks them complete (None on the CPU, where the work is already done).
    `realize` is the only place the host waits."""

    def __init__(self, yr: torch.Tensor, yi: torch.Tensor, event=None):
        self.yr, self.yi, self.event = yr, yi, event

    def realize(self) -> tuple[np.ndarray, np.ndarray]:
        """Wait for the transform and copy it to host numpy planes."""
        if self.event is None:
            return self.yr.numpy(), self.yi.numpy()
        self.event.synchronize()
        out = []
        for y in (self.yr, self.yi):
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            host.copy_(y)
            out.append(host.numpy())
        return out[0], out[1]


class ExecutablePlan:
    """Frozen plan: resolved strategy + cost model + built executables.

    Construct via `repro_torch.fft.plan(...)`, never directly — the
    module-level cache is what makes repeat plans free.
    """

    def __init__(self, spec: FftSpec):
        object.__setattr__(self, "_frozen", False)
        self.spec = spec
        self.device = torch.device(spec.device)
        #: level-0/1/2 factorization of the transform length
        self.leaf = kplan.make_plan(max(spec.n, 1))
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
                f"levels={self.leaf.levels})")

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
    def batch_shape(self) -> tuple:
        return self.spec.batch_shape

    @property
    def placement(self) -> str:
        return self.spec.placement

    @property
    def levels(self) -> int:
        return self.leaf.levels

    # ------------------------------------------------------------------
    # analytic cost model (roofline numerators)

    @property
    def flops_per_row(self) -> float:
        """Algorithmic FLOPs per batch row (the 5 n log2 n convention)."""
        n = self.spec.n
        return 5.0 * n * math.log2(n) if n > 1 else 0.0

    @property
    def flops(self) -> float:
        return self.spec.rows * self.flops_per_row

    @property
    def gemm_macs_per_row(self) -> float:
        """Real MACs the matrix formulation issues per batch row."""
        return self.leaf.gemm_macs

    @property
    def gemm_macs(self) -> float:
        return self.spec.rows * self.gemm_macs_per_row

    @property
    def hbm_bytes_per_row(self) -> int:
        """Planar-f32 payload device-memory bytes per batch row (tables
        excluded)."""
        return kplan.fft_hbm_bytes(self.spec.n, self.spec.layout)

    @property
    def hbm_bytes(self) -> int:
        return self.spec.rows * self.hbm_bytes_per_row

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
        if s.impl == "matfft":
            _upload_tables(s.n, dev)
            if dev.type == "cuda":
                kmatfft._lib()  # build (first use) and bind the kernels
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
        self._builds["forward"] += 1

        def forward(xr, xi):
            return executors.fft(xr, xi, impl=s.impl, layout=s.layout)

        return forward

    def _inverse(self):
        if self._inv is None:
            with self._build_lock:
                if self._inv is None:
                    fwd = self._forward()
                    n = self.spec.n

                    def inverse(yr, yi):
                        # conjugation identity on the forward transform
                        ar, ai = fwd(yr, -yi)
                        return ar / n, -ai / n

                    self._builds["inverse"] += 1
                    self._inv = inverse
        return self._inv

    # ------------------------------------------------------------------

    def _operand(self, x, what: str) -> torch.Tensor:
        x = torch.as_tensor(x)
        if tuple(x.shape) != self.spec.operand_shape:
            raise ValueError(
                f"{what}: plan was built for shape {self.spec.operand_shape} "
                f"(batch_shape={self.spec.batch_shape}, "
                f"shape={self.spec.shape}), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: operands must be float32, got "
                            f"{x.dtype}")
        return x

    def execute(self, xr, xi):
        """Forward c2c transform of planar (*batch_shape, n) float32
        operands, on the caller's current stream. Returns planes on the
        plan's device."""
        xr = self._operand(xr, "execute").to(self.device)
        xi = self._operand(xi, "execute").to(self.device)
        return self._forward()(xr, xi)

    def execute_inverse(self, yr, yi):
        """Inverse c2c transform: planar spectrum -> planar signal."""
        yr = self._operand(yr, "execute_inverse").to(self.device)
        yi = self._operand(yi, "execute_inverse").to(self.device)
        return self._inverse()(yr, yi)

    def execute_async(self, *operands, donate: bool = False) -> AsyncResult:
        """Launch the forward transform of host operands WITHOUT waiting
        for it.

        On CUDA the operands are copied to the device on the plan's own
        stream (``non_blocking``: from pinned host memory the copy is
        asynchronous), the kernels are launched there, and an event is
        recorded. The returned `AsyncResult` realizes to host planes.
        ``donate=True`` hands the operands to the launch: the caller must
        not write them until the result is realized (the stream executor's
        staging pool releases them only then). ``donate=False`` returns
        after the operands have been copied, so they may be reused at once.
        """
        if len(operands) != 2:
            raise ValueError(
                f"execute_async on a 'c2c' plan takes 2 operand(s), got "
                f"{len(operands)}")
        xr, xi = (self._operand(x, "execute_async") for x in operands)
        fwd = self._forward()
        if self.device.type == "cpu":
            yr, yi = fwd(xr, xi)
            return AsyncResult(yr, yi)
        with torch.cuda.stream(self._stream):
            dr = xr.to(self.device, non_blocking=True)
            di = xi.to(self.device, non_blocking=True)
            if not donate:
                staged = torch.cuda.Event()
                staged.record(self._stream)
            yr, yi = fwd(dr, di)
            done = torch.cuda.Event()
            done.record(self._stream)
        if not donate:
            staged.synchronize()
        return AsyncResult(yr, yi, done)


# ---------------------------------------------------------------------------
# the facade


def plan(kind: str = "c2c", *, n: int | None = None, shape=None,
         batch_shape=(), placement: str = "auto", layout: str = "zero_copy",
         impl: str = "matfft", precision: str = "f32", device="cuda",
         verify: str = "off") -> ExecutablePlan:
    """Resolve a transform spec and return the cached `ExecutablePlan`.

    Args:
      kind: "c2c" (planar complex). "r2c" is not ported yet.
      n: 1-D transform length — sugar for ``shape=(n,)``; pass exactly one
        of ``n``/``shape`` (power-of-two lengths).
      batch_shape: leading batch dims of the operands.
      placement: "auto" or "local"; the other placements are not ported
        yet and raise `NotImplementedError`.
      layout: "zero_copy" (default) or "copy" (the measured baseline).
      impl: leaf kernel ("matfft", or "ref" for torch.fft; "stockham"
        raises until its kernel is ported).
      precision: "f32".
      device: "cuda" (default; raises when no card is present) or "cpu",
        which runs the kernels' plain PyTorch versions.
      verify: ABFT mode for consumers that run the plan's invariant checks:
        "off", "parseval" or "abft". Verified and unverified plans are
        distinct cache entries.

    Same resolved spec -> the SAME plan object, with its tables already
    on the device.
    """
    resolved = spec_mod.resolve(
        kind=kind, n=n, shape=shape, batch_shape=batch_shape,
        placement=placement, layout=layout, impl=impl, precision=precision,
        device=device, verify=verify)
    with _CACHE_LOCK:
        cached = _PLAN_CACHE.get(resolved)
        if cached is not None:
            _CACHE_INFO["hits"] += 1
            return cached
        _CACHE_INFO["misses"] += 1
        p = ExecutablePlan(resolved)
        _PLAN_CACHE[resolved] = p
        return p


def cache_info() -> dict:
    """Process-level plan-cache stats: {entries, hits, misses}."""
    with _CACHE_LOCK:
        return {**_CACHE_INFO, "entries": len(_PLAN_CACHE)}


def clear_plan_cache() -> None:
    """Drop every cached plan and reset the cache counters."""
    with _CACHE_LOCK:
        _PLAN_CACHE.clear()
        _CACHE_INFO["hits"] = 0
        _CACHE_INFO["misses"] = 0
