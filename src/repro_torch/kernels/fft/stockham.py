"""Radix-2 Stockham autosort FFT: the Hopper kernel K4 and its plain
PyTorch version.

  * ``stockham_fft``  forward DFT along the last axis of planar (rows, n)
    float32, n a power of two <= MAX_LEAF, natural-order output.

The kernel lives in ``csrc/stockham.cu`` (CUDA C++ for ``sm_90a``, built by
`repro_torch.kernels.build` and called through ctypes). It replaces the
Pallas kernel of the JAX package's ``kernels/fft/stockham.py``
(``stockham_fft``, body ``_stockham_kernel``): log2(n) decimation-in-
frequency butterfly stages, no bit reversal, the per-stage twiddles packed
in one (n,) planar table (`plan.stockham_twiddles`, stage offsets
`plan.stockham_stage_offsets`). It is the comparison implementation
against the matrix formulation of `matfft`, the `impl="stockham"` leaf.

The kernel runs the stages in groups of up to four, each group in one
thread's registers, and passes data between groups through shared memory
(n = 1024: 4 + 4 + 2 stages, two exchanges). `_stockham_grouped_plain`
spells out its index maps with tensor views; it computes the same
butterflies as ``stockham_fft_plain``, so the two, and the kernel, agree
bit for bit.

On a CUDA tensor the wrapper launches the kernel (counted in
``stockham_fft.launches``) or raises; on a CPU tensor it runs
``stockham_fft_plain`` (counted in ``stockham_fft_plain.calls``), which
repeats the stages with PyTorch operations. Each call's shape goes to
`matfft`'s ``launch_shapes`` or ``plain_shapes`` as well.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fft import plan as fft_plan
from repro_torch.kernels.fft.matfft import (Planar, _check_cuda, _check_planes,
                                            _contiguous, _device_table,
                                            _launch_key, launch_shapes,
                                            plain_shapes, stockham_stages)


def stockham_table(n: int, device: torch.device) -> Planar:
    """The packed per-stage twiddles of a length-n transform on
    ``device``."""
    return _device_table(("stockham", n),
                         lambda: fft_plan.stockham_twiddles(n), device)


def _check(xr, xi) -> tuple[int, int]:
    _check_planes(xr, xi, 2, "stockham_fft")
    rows, n = xr.shape
    fft_plan.log2i(n)
    if n > fft_plan.MAX_LEAF:
        raise ValueError(f"n={n} exceeds single-kernel capacity "
                         f"(MAX_LEAF={fft_plan.MAX_LEAF}); use executors.fft")
    return rows, n


def stockham_fft_plain(xr: torch.Tensor, xi: torch.Tensor) -> Planar:
    """Plain PyTorch version of `stockham_fft`, same stages and rounding."""
    stockham_fft_plain.calls += 1
    _, n = _check(xr, xi)
    if n == 1:
        return xr, xi
    twr, twi = stockham_table(n, xr.device)
    return stockham_stages(
        xr, xi, ((twr[off:off + l], twi[off:off + l])
                 for off, l, _ in fft_plan.stockham_stage_offsets(n)))


stockham_fft_plain.calls = 0

GROUP = 4  # stages a group of the kernel


def _brev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _stockham_grouped_plain(xr: torch.Tensor, xi: torch.Tensor) -> Planar:
    """`stockham_fft_plain` computed in the kernel's groups of stages: the
    index maps of ``csrc/stockham.cu`` written with tensor views. On no
    path; the tests hold it to ``stockham_fft_plain`` bit for bit.

    A group starts at stage s and runs g <= GROUP stages (the short group
    last), Q = 2^g, ms = 2^s, J = n / (ms Q). It reads row r as (Q, J,
    ms): register q of item (j, k) is x[(j + q J) ms + k]. Stage t pairs
    registers i and i + h, h = Q >> (t+1), in each block of 2h, with
    twiddle entry off_{s+t} + i J + j. Register rho then holds output c =
    brev_g(rho), written to row r as (J, Q, ms): y[(j Q + c) ms + k]."""
    _, n = _check(xr, xi)
    if n == 1:
        return xr, xi
    rows = xr.shape[0]
    log_n = fft_plan.log2i(n)
    twr, twi = stockham_table(n, xr.device)
    s = 0
    while s < log_n:
        g = min(GROUP, log_n - s)
        q_, ms = 1 << g, 1 << s
        j_ = n // (ms * q_)
        vr = list(xr.reshape(rows, q_, j_, ms).unbind(1))
        vi = list(xi.reshape(rows, q_, j_, ms).unbind(1))
        for t in range(g):
            h = q_ >> (t + 1)
            off = n - (n >> (s + t))
            for i in range(h):
                lo = off + i * j_
                wr = twr[lo:lo + j_].reshape(1, j_, 1)
                wi = twi[lo:lo + j_].reshape(1, j_, 1)
                for blk in range(0, q_, 2 * h):
                    a, b = blk + i, blk + i + h
                    ar, ai, br, bi = vr[a], vi[a], vr[b], vi[b]
                    vr[a], vi[a] = ar + br, ai + bi
                    dr, di = ar - br, ai - bi
                    vr[b] = wr * dr - wi * di
                    vi[b] = wr * di + wi * dr
        order = [_brev(c, g) for c in range(q_)]
        xr = torch.stack([vr[rho] for rho in order], dim=2).reshape(rows, n)
        xi = torch.stack([vi[rho] for rho in order], dim=2).reshape(rows, n)
        s += g
    return xr, xi

_BOUND = threading.Event()


def _lib() -> ctypes.CDLL:
    lib = build.load("stockham")
    if not _BOUND.is_set():
        lib.stockham_rows.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int] + \
            [ctypes.c_void_p] * 3
        lib.stockham_rows.restype = ctypes.c_int
        _BOUND.set()
    return lib


def stockham_fft(xr: torch.Tensor, xi: torch.Tensor) -> Planar:
    """Batched forward DFT along the last axis of planar (rows, n) float32
    tensors via radix-2 Stockham stages; n a power of two <= MAX_LEAF.
    n == 1 returns its input. A block takes MAX_LEAF // n rows."""
    key = _launch_key("stockham", xr.shape, None)
    if xr.device.type == "cpu":
        plain_shapes[key] += 1
        return stockham_fft_plain(xr, xi)
    _check_cuda(xr, "stockham_fft")
    rows, n = _check(xr, xi)
    if n == 1:
        return xr, xi
    _contiguous(xr, xi, what="stockham_fft")
    twr, twi = stockham_table(n, xr.device)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    rc = _lib().stockham_rows(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows, n,
        twr.data_ptr(), twi.data_ptr(),
        torch.cuda.current_stream(xr.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"stockham_fft kernel launch failed: CUDA error {rc}")
    stockham_fft.launches += 1
    launch_shapes[key] += 1
    return yr, yi


stockham_fft.launches = 0


def reset_counts() -> None:
    """Zero this module's launch and plain-call counters."""
    stockham_fft.launches = 0
    stockham_fft_plain.calls = 0
