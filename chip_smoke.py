#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py             # on a machine with an H100
    python3 chip_smoke.py --rehearse  # tiny sizes, CPU, plain versions

Phases (any failed check exits non-zero):

  1. device: the card's name and power limit (nvidia-smi), CUDA version;
  2. build: compile every kernel from csrc/ with nvcc, all at once, print
     what ptxas reports (registers, shared memory, spills);
  3. kernels against their plain PyTorch versions and torch.fft on the card
     (K1 at n = 256, 512, 1024, 2048, MAX_LEAF with and without the
     epilogue; K2 at L = 256, 1024, MAX_LEAF, row- and column-major, with
     the epilogue; K3 at n = 8, 512, 1024, 4096, 8192 with and without
     the untangle; K4 at every power of two from 2 to MAX_LEAF, every
     split of its groups of stages; one error formula; K1-K4 equal to
     their plain versions bit for bit), batch invariance (a row alone ==
     the row inside a large batch: K1 at n = 256, 1024, 2048, 4096, K3 at
     512, 1024, 2048, 4096, K4 at 256, 1024, 2048, 4096),
     zero_copy == copy bitwise at 2^16, 2^17 and 2^20 (K2's column passes
     against K1's row passes over transposes), and each variant's
     main-path case timed beside its bound, its plain version and
     torch.fft (a yardstick only);
  4. main path: the map-only FFT job (`repro_torch.launch.fft_job`) driven
     pipelined through its CLI entry point, once per K1/K2 variant, once
     past MAX_LEAF**2 (three levels) and twice with --impl stockham (K4
     leaves, and the copy path at 2^20), each with the launch counts
     zeroed just before and read just after: every output block within
     5e-6 of torch.fft.fft of its input block, the kernel launched, the
     plain versions never called;
  5. serial against pipelined: the merged outputs equal bitwise;
  6. the spectrogram job of examples/spectral_analysis.py through the
     port: a 1 GiB real capture in 64 MiB blocks, a map-only job whose map
     task is `repro_torch.core.spectral.power_spectrogram` on the card, at
     frame 1024 (K3 at m = 512, three passes) and frame 512 (K3 at m =
     256, two passes): every block's
     stft within 5e-6 of torch.fft.rfft of the same windowed frames, the
     three tones found within one bin, the chirp found, K3 launched and
     no plain version run;
  7. `fft_conv` on the card (n = 8192 through K3 and K1; n = 2^21 through
     K2) within 1e-4 of a float64 torch.fft convolution;
  8. the `kernels` JSON line: phase 3's numbers and the main-path
     launches (phases 4 and 6).

The last line is {"ok": true, "device": {...}}. Without a CUDA card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 5e-6  # max|got - want| / max|want|, the selftest's bar
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_S = 67e12    # H100 SXM f32 outside the tensor cores

TOL_CONV = 1e-4  # fft_conv against float64 (tests/test_spectral.py's bar)

# the Pallas sites each kernel variant replaces, and its CUDA source
REPLACES = {
    "matfft/direct": "src/repro/kernels/fft/matfft.py:234",
    "matfft/four_step": "src/repro/kernels/fft/matfft.py:252",
    "matfft_cols/direct": "src/repro/kernels/fft/matfft.py:419",
    "matfft_cols/four_step": "src/repro/kernels/fft/matfft.py:438",
    "rfft/direct": "src/repro/kernels/fft/matfft.py:559",
    "rfft/four_step": "src/repro/kernels/fft/matfft.py:578",
    "stockham": "src/repro/kernels/fft/stockham.py:80",
}
SOURCE = {name: "src/repro_torch/csrc/matfft.cu" for name in REPLACES}
SOURCE["stockham"] = "src/repro_torch/csrc/stockham.cu"

# examples/spectral_analysis.py's capture
SR = 16_000
TONES_HZ = (440.0, 1_250.0, 3_000.0)

# main-path runs: (label, kernel it drives, fft_job arguments). Pipelined,
# with 64 MiB (level 0) to 256 MiB (level 2) blocks. A label that names a
# kernel variant gives that variant its launch count in the `kernels` line.
FULL = {
    "runs": [
        ("matfft/four_step", "matfft",
         ["--fft-len", "1024", "--size-mb", "1024",
                              "--segments-per-block", "8192",
                              "--coalesce", "4", "--inflight", "2"]),
        ("matfft_cols/four_step", "matfft_cols",
         ["--fft-len", "1048576", "--size-mb", "256",
          "--segments-per-block", "16", "--coalesce", "2", "--inflight", "2"]),
        ("matfft/direct", "matfft",
         ["--fft-len", "256", "--size-mb", "256",
          "--segments-per-block", "32768", "--coalesce", "4",
          "--inflight", "2"]),
        ("matfft_cols/direct", "matfft_cols",
         ["--fft-len", "65536", "--size-mb", "256",
          "--segments-per-block", "128", "--coalesce", "4",
          "--inflight", "2"]),
        # past MAX_LEAF**2: three levels, 256 x (512 x 256)
        ("three_levels", "matfft_cols",
         ["--fft-len", str(1 << 25), "--size-mb", "512",
          "--segments-per-block", "1", "--coalesce", "2", "--inflight", "2"]),
        # K4 leaves: the first run's configuration, then the level-1 copy
        # path (transposes around two K4 passes) at 2^20
        ("stockham", "stockham",
         ["--impl", "stockham", "--fft-len", "1024", "--size-mb", "1024",
          "--segments-per-block", "8192", "--coalesce", "4",
          "--inflight", "2"]),
        ("stockham_copy_path", "stockham",
         ["--impl", "stockham", "--fft-len", "1048576", "--size-mb", "256",
          "--segments-per-block", "16", "--coalesce", "2",
          "--inflight", "2"]),
    ],
    # serial vs pipelined: 4 blocks of the first run's configuration
    "serial": ["--fft-len", "1024", "--size-mb", "256",
               "--segments-per-block", "8192", "--coalesce", "4"],
    "points": 1 << 25,      # complex points per kernel check and timing
    "batch_rows": 32768,    # batch of the invariance check
    "layout_rows": 64,      # rows of the zero_copy == copy check
    "reps": 10,
    # K3 (rows, n): n = 8, the frame-512 and frame-1024 spectrogram blocks
    # (2^24 samples), n = 4096 and fft_conv's n = 8192 at 2^25 samples
    "rfft_shapes": [(1 << 22, 8), (65535, 512), (32767, 1024), (8192, 4096),
                    (4096, 8192)],
    # K4 (rows, n) at 2^25 points, n = 2 to 4096: every split of its
    # groups of stages; (32768, 1024) is the main path's batch
    "stockham_shapes": [((1 << 25) >> p, 1 << p) for p in range(1, 13)],
    # the spectrogram job: 1 GiB of float32 samples at 16 kHz, 64 MiB
    # blocks; (variant, frame, hop) per run
    "capture_samples": 1 << 28,
    "block_samples": 1 << 24,
    "spectrograms": [("rfft/four_step", 1024, 512), ("rfft/direct", 512, 256)],
    # fft_conv: (signals, samples, filter taps)
    "conv": [(64, 4000, 100), (16, 1 << 20, 4097)],
}
REHEARSE = {
    "runs": [
        ("matfft/four_step", "matfft",
         ["--fft-len", "1024", "--size-mb", "1", "--segments-per-block",
          "32", "--coalesce", "4", "--inflight", "2"]),
        ("matfft_cols/four_step", "matfft_cols",
         ["--fft-len", "16384", "--size-mb", "1", "--segments-per-block",
          "2", "--coalesce", "2", "--inflight", "2"]),
        ("matfft/direct", "matfft",
         ["--fft-len", "256", "--size-mb", "1", "--segments-per-block",
          "128", "--coalesce", "4", "--inflight", "2"]),
        ("matfft_cols/direct", "matfft_cols",
         ["--fft-len", "65536", "--size-mb", "1", "--segments-per-block",
          "1", "--coalesce", "2", "--inflight", "2"]),
        ("stockham", "stockham",
         ["--impl", "stockham", "--fft-len", "1024", "--size-mb", "1",
          "--segments-per-block", "32", "--coalesce", "4", "--inflight", "2"]),
        ("stockham_copy_path", "stockham",
         ["--impl", "stockham", "--fft-len", "16384", "--size-mb", "1",
          "--segments-per-block", "2", "--coalesce", "2", "--inflight", "2"]),
    ],
    "serial": ["--fft-len", "1024", "--size-mb", "1",
               "--segments-per-block", "32", "--coalesce", "4"],
    "points": 1 << 15,
    "batch_rows": 64,
    "layout_rows": 2,
    "reps": 1,
    "rfft_shapes": [(64, 8), (33, 512), (17, 1024), (5, 4096), (3, 8192)],
    "stockham_shapes": [(max(2, (1 << 13) >> p), 1 << p)
                        for p in range(1, 13)],
    "capture_samples": 1 << 18,
    "block_samples": 1 << 16,
    "spectrograms": [("rfft/four_step", 1024, 512), ("rfft/direct", 512, 256)],
    "conv": [(4, 200, 10), (2, 8192, 4097)],
}


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel_err(got, want) -> float:
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, reps: int) -> float:
    """Mean time of one call from CUDA events over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions and torch.fft; each
# variant's main-path case is timed beside its bound, plain and torch.fft


def kernel_cases(cfg, max_leaf: int) -> list:
    """(variant, wrapper, shape, options, timed): K1 at n = 256, 512,
    1024, 2048, MAX_LEAF with and without the periodic epilogue, K2 at L =
    256, 1024, MAX_LEAF row- and column-major with the epilogue, K3 at
    ``rfft_shapes`` with and
    without the untangle, K4 at ``stockham_shapes``. ``timed`` marks each
    variant's main-path case: the level-0 batch (coalesce 4 x 8192
    segments of 1024, or 4 x 32768 of 256), the level-1 first pass
    (2^20 points: 2 blocks x 16 segments as (32, 1024, 1024); 2^16: 4 x 128
    as (512, 256, 256)), all at 2^25 points; K3 at a spectrogram block's
    frames (65535 x 512, 32767 x 1024); K4 at the stockham run's batch
    (32768 x 1024)."""
    points = cfg["points"]
    cases = []
    for n in (256, 512, 1024, 2048, max_leaf):
        variant = "matfft/direct" if n <= 256 else "matfft/four_step"
        for period in (None, 64):
            cases.append((variant, "matfft", (points // n, n),
                          {"period": period},
                          period is None and n in (256, 1024)))
    for L in (256, 1024, max_leaf):
        variant = "matfft_cols/direct" if L <= 256 else \
            "matfft_cols/four_step"
        for out_major in ("row", "col"):
            cases.append((variant, "matfft_cols",
                          (max(points // (L * L), 1), L, L),
                          {"out_major": out_major},
                          out_major == "row" and L in (256, 1024)))
    for rows, n in cfg["rfft_shapes"]:
        variant = "rfft/direct" if n // 2 <= 256 else "rfft/four_step"
        for untangle in (True, False):
            cases.append((variant, "rfft", (rows, n), {"untangle": untangle},
                          untangle and n in (512, 1024)))
    for rows, n in cfg["stockham_shapes"]:
        cases.append(("stockham", "stockham", (rows, n), {}, n == 1024))
    return cases


def case_work(km, ks, kplan, kernel: str, shape, opts, epi, dev):
    """(bytes, flops) of one call: each input read once (the tables too),
    each output written once; 5 n log2 n flops a complex row, 6 a point
    for an epilogue's complex product, and for K3 the reference planner's
    count, 5 m log2 m + 10 m a row (m = n/2)."""
    def table_bytes(tables):
        return sum(t.numel() * 4 for t in tables)

    if kernel in ("matfft", "matfft_cols"):
        if kernel == "matfft":
            rows, n = shape
        else:
            B, n, C = shape
            rows = B * C
        nbytes = (rows * kplan.fft_hbm_bytes(n)
                  + table_bytes(km.leaf_tables(n, dev))
                  + (table_bytes(epi) if epi is not None else 0))
        flops = rows * (5.0 * n * math.log2(n)
                        + (6.0 * n if epi is not None else 0.0))
    elif kernel == "rfft":
        rows, n = shape
        m = n // 2
        width = m + 1 if opts["untangle"] else m
        nbytes = (rows * (4 * n + 8 * width)
                  + table_bytes(km.leaf_tables(m, dev))
                  + table_bytes(km.rfft_twiddle(n, dev)))
        flops = rows * (5.0 * m * math.log2(m) + 10.0 * m)
    else:
        rows, n = shape
        nbytes = rows * 16 * n + table_bytes(ks.stockham_table(n, dev))
        flops = rows * 5.0 * n * math.log2(n)
    return nbytes, flops


def kernel_checks(torch, dev, cfg, gpu: bool) -> tuple[list, dict, dict]:
    import numpy as np

    from repro_torch.fft import executors
    from repro_torch.kernels.fft import matfft as km
    from repro_torch.kernels.fft import plan as kplan
    from repro_torch.kernels.fft import stockham as ks

    rng = np.random.default_rng(0)
    reps = cfg["reps"]

    def real(shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    def planes(shape):
        a = rng.standard_normal((2, *shape), dtype=np.float32)
        return (torch.from_numpy(a[0]).to(dev), torch.from_numpy(a[1]).to(dev))

    def unit_table(shape):
        ang = rng.uniform(-math.pi, math.pi, size=shape)
        return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(dev),
                torch.from_numpy(np.sin(ang).astype(np.float32)).to(dev))

    def times(epi, er, ei):  # (rows, n) planes times per-row table rows
        return er * epi[0] - ei * epi[1], er * epi[1] + ei * epi[0]

    checks, timing = [], {}
    for variant, kernel, shape, opts, timed in kernel_cases(
            cfg, kplan.MAX_LEAF):
        epi = None
        if kernel == "matfft":
            xr, xi = planes(shape)
            xc = torch.complex(xr, xi)
            rows, n = shape
            epi = unit_table((opts["period"], n)) if opts["period"] else None
            run = lambda: km.matfft(xr, xi, epilogue=epi)  # noqa: E731
            plain = lambda: km.matfft_plain(xr, xi, epilogue=epi)  # noqa
            lib = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
            y = lib()
            want = (y.real, y.imag)
            if epi is not None:
                idx = torch.arange(rows, device=dev) % opts["period"]
                want = times((epi[0][idx], epi[1][idx]), *want)
        elif kernel == "matfft_cols":
            xr, xi = planes(shape)
            xc = torch.complex(xr, xi)
            B, n, C = shape
            rows = B * C
            epi = unit_table((C, n))
            major = opts["out_major"]
            run = lambda: km.matfft_cols(  # noqa: E731
                xr, xi, out_major=major, epilogue=epi)
            plain = lambda: km.matfft_cols_plain(  # noqa: E731
                xr, xi, out_major=major, epilogue=epi)
            lib = lambda: torch.fft.fft(xc, dim=1)  # noqa: E731
            y = lib().transpose(1, 2).reshape(rows, n)
            want = times((epi[0].repeat(B, 1), epi[1].repeat(B, 1)),
                         y.real, y.imag)
            if major == "col":
                want = tuple(t.reshape(B, C, n).transpose(1, 2) for t in want)
        elif kernel == "rfft":
            x = real(shape)
            if opts["untangle"]:
                run = lambda: km.rfft_leaf(x)  # noqa: E731
                plain = lambda: km.rfft_leaf_plain(x)  # noqa: E731
                lib = lambda: torch.fft.rfft(x, dim=-1)  # noqa: E731
            else:  # the packed half spectrum: the DFT of x[0::2] + i x[1::2]
                xc = torch.complex(x[:, 0::2], x[:, 1::2])
                run = lambda: km.rfft_pack_leaf(x)  # noqa: E731
                plain = lambda: km.rfft_pack_leaf_plain(x)  # noqa: E731
                lib = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
            y = lib()
            want = (y.real, y.imag)
        else:
            xr, xi = planes(shape)
            xc = torch.complex(xr, xi)
            run = lambda: ks.stockham_fft(xr, xi)  # noqa: E731
            plain = lambda: ks.stockham_fft_plain(xr, xi)  # noqa: E731
            lib = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
            y = lib()
            want = (y.real, y.imag)
        got = run() if gpu else plain()
        ref = plain()
        got_c = torch.complex(*got)
        max_abs = float((got_c - torch.complex(*ref)).abs().max())
        c = {"variant": variant, "shape": list(shape), **opts,
             "epilogue": list(epi[0].shape) if epi is not None else None,
             "max_abs_err": max_abs, "bitwise_plain": max_abs == 0.0,
             "rel_err_plain": max_abs / float(torch.complex(*ref).abs().max()),
             "rel_err_torch_fft": rel_err(got_c, torch.complex(*want))}
        print("check " + json.dumps(c))
        checks.append(c)
        check(c["rel_err_plain"] < TOL and c["rel_err_torch_fft"] < TOL,
              f"kernel disagrees: {c}")
        if gpu:  # every kernel rounds as its plain version
            check(c["bitwise_plain"], f"kernel differs from its plain "
                  f"version: {c}")
        del got, ref, got_c, want, y
        if gpu and timed:
            # plain, kernel, kernel, plain: one card, one call
            t_plain = [timed_ms(torch, plain, reps)]
            t_kernel = [timed_ms(torch, run, reps), timed_ms(torch, run, reps)]
            t_plain.append(timed_ms(torch, plain, reps))
            nbytes, flops = case_work(km, ks, kplan, kernel, shape, opts, epi,
                                      dev)
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_flops = flops / F32_FLOPS_S * 1e3
            timing[variant] = {
                "case": c, "bytes": nbytes, "flops": flops,
                "max_abs_err": max_abs, "max_rel_err": c["rel_err_plain"],
                "bitwise_plain": c["bitwise_plain"],
                "ms": min(t_kernel), "ms_runs": t_kernel,
                "plain_ms": min(t_plain), "plain_ms_runs": t_plain,
                "library_ms": timed_ms(torch, lib, reps),
                "bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
        del run, plain, lib

    # batch invariance: row 0 alone == row 0 inside the big batch, bitwise;
    # K1, K3 and K4 at lengths of two and of three passes or groups (K3 at
    # n = 512 runs m = 256)
    invariance = {}
    for name, fn, lengths, real_rows in (
            ("matfft", km.matfft if gpu else km.matfft_plain,
             (256, 1024, 2048, 4096), False),
            ("rfft_leaf", km.rfft_leaf if gpu else km.rfft_leaf_plain,
             (512, 1024, 2048, 4096), True),
            ("rfft_pack_leaf",
             km.rfft_pack_leaf if gpu else km.rfft_pack_leaf_plain,
             (512, 1024, 2048, 4096), True),
            ("stockham_fft", ks.stockham_fft if gpu else ks.stockham_fft_plain,
             (256, 1024, 2048, 4096), False)):
        for n in lengths:
            args = (real((cfg["batch_rows"], n)),) if real_rows else planes(
                (cfg["batch_rows"], n))
            alone = fn(*(a[:1].contiguous() for a in args))
            batch = fn(*args)
            key = f"{name}/{n}"
            invariance[key] = (torch.equal(alone[0][0], batch[0][0])
                               and torch.equal(alone[1][0], batch[1][0]))
            print(f"batch invariance of {name} (1 row vs {cfg['batch_rows']} "
                  f"rows, n={n}): "
                  f"{'bitwise equal' if invariance[key] else 'DIFFERENT'}")
            if gpu:  # the plain versions' matmuls need not be batch invariant
                check(invariance[key],
                      f"{name}: row 0 alone differs from row 0 in the batch "
                      f"at n={n}")

    # zero_copy == copy: K2's column passes (L = 256, 512 and 1024) against
    # K1's row passes over materialized transposes, bitwise
    for n in (1 << 16, 1 << 17, 1 << 20):
        xr, xi = planes((cfg["layout_rows"], n))
        zc = executors.fft(xr, xi, layout="zero_copy")
        cp = executors.fft(xr, xi, layout="copy")
        same = torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])
        invariance[f"zero_copy==copy/{n}"] = same
        print(f"zero_copy vs copy ({cfg['layout_rows']} rows, n={n}): "
              f"{'bitwise equal' if same else 'DIFFERENT'}")
        if gpu:
            check(same, f"zero_copy and copy differ at n={n}")
        del zc, cp
    return checks, invariance, timing


def kernel_line(timing: dict, launches: dict) -> list:
    """The `kernels` entries: measured numbers, the main path's launch
    counts and the bound; each variant's shape, bytes and flops stay in
    chiprun_out/chip_smoke.json."""
    return [{"name": name, "route": "cuda", "source": SOURCE[name],
             "replaces": REPLACES[name], "launches": launches[name],
             **{k: t[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                  "bitwise_plain", "ms_runs", "plain_ms",
                                  "plain_ms_runs",
                                  "library_ms", "bound_ms", "bound_by")}}
            for name, t in timing.items()]


# ---------------------------------------------------------------------------
# phases 4-5: the main path through fft_job


def run_job(argv: list) -> dict:
    from repro_torch.launch import fft_job
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = fft_job.main(argv)
    return report


def check_job_output(torch, dev, work: Path, fft_len: int) -> float:
    """Every output block within TOL of torch.fft.fft of its input block;
    returns the worst block's error."""
    import numpy as np

    from repro_torch.core.pipeline import BlockStore, segments_of_block

    store = BlockStore.open(work / "in")
    worst = 0.0
    for i, info in enumerate(store.blocks):
        re, im = segments_of_block(store.read_block(i), fft_len)
        out_file = work / "out" / info.name()
        yr, yi = segments_of_block(out_file.read_bytes(), fft_len)
        x = torch.complex(torch.from_numpy(re).to(dev),
                          torch.from_numpy(im).to(dev))
        want = torch.fft.fft(x, dim=-1)
        got = torch.complex(torch.from_numpy(yr).to(dev),
                            torch.from_numpy(yi).to(dev))
        check(bool(torch.isfinite(got).all()), f"block {i}: non-finite")
        e = rel_err(got, want)
        check(e < TOL, f"block {i}: {e} vs torch.fft.fft")
        worst = max(worst, e)
        del x, want, got
    check(np.isfinite(worst), "no blocks checked")
    return worst


def reset_counts() -> None:
    from repro_torch.kernels.fft import matfft as km
    from repro_torch.kernels.fft import stockham as ks
    km.reset_counts()
    ks.reset_counts()


def read_counts() -> dict:
    """Launches of every kernel wrapper, and the plain versions' calls in
    all, since the last `reset_counts`."""
    from repro_torch.kernels.fft import matfft as km
    from repro_torch.kernels.fft import stockham as ks
    return {"matfft": km.matfft.launches,
            "matfft_cols": km.matfft_cols.launches,
            "rfft_leaf": km.rfft_leaf.launches,
            "rfft_pack_leaf": km.rfft_pack_leaf.launches,
            "stockham": ks.stockham_fft.launches,
            "plain": (km.matfft_plain.calls + km.matfft_cols_plain.calls
                      + km.rfft_leaf_plain.calls
                      + km.rfft_pack_leaf_plain.calls
                      + ks.stockham_fft_plain.calls)}


def check_main_path(gpu: bool, name: str, counts: dict, kernel: str) -> None:
    if gpu:
        check(counts[kernel] > 0, f"{name}: {kernel} never launched")
        check(counts["plain"] == 0,
              f"{name}: a plain version ran on the main path")
    else:
        check(counts["plain"] > 0, f"rehearsal {name}: plain path not run")


# ---------------------------------------------------------------------------
# phase 6: the spectrogram job of examples/spectral_analysis.py


def synth_capture(torch, dev, samples: int, seed: int = 0):
    """The example's capture at ``samples`` samples: three tones, a 0.5 s
    chirp in the middle, Gaussian noise from numpy's generator; tones and
    chirp computed on ``dev`` in float64, 2^24 samples at a time. Returns
    float32 numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = np.empty(samples, np.float32)
    mid = samples // 2
    w = torch.arange(SR // 2, dtype=torch.float64, device=dev) / SR
    chirp = 2.0 * torch.sin(2 * math.pi * (2000 + 6000 * w) * w * SR)
    step = 1 << 24
    for s in range(0, samples, step):
        e = min(samples, s + step)
        t = torch.arange(s, e, dtype=torch.float64, device=dev) / SR
        x = 0.05 * torch.from_numpy(rng.standard_normal(e - s)).to(dev)
        for hz in TONES_HZ:
            x += torch.sin(2 * math.pi * hz * t)
        lo, hi = max(s, mid), min(e, mid + SR // 2)
        if lo < hi:
            x[lo - s:hi - s] += chirp[lo - mid:hi - mid]
        out[s:e] = x.float().cpu().numpy()
    return out


def spectrogram_run(torch, dev, gpu: bool, store, work: Path, variant: str,
                    frame: int, hop: int) -> dict:
    """One map-only spectrogram job over ``store`` (the example's steps 2
    and 3), its launch counts read just after the job, then its checks."""
    import numpy as np

    from repro_torch.core.pipeline import JobConfig, MapOnlyJob
    from repro_torch.core.spectral import power_spectrogram, stft

    def map_fn(data, idx):
        x = torch.from_numpy(np.frombuffer(data, np.float32).copy())
        ps = power_spectrogram(x, frame, hop, device=dev)
        return ps.cpu().numpy().tobytes()

    job = MapOnlyJob(store, work / "out", map_fn, JobConfig(workers=4))
    reset_counts()
    t0 = time.monotonic()
    stats = job.run()
    job_s = time.monotonic() - t0
    counts = read_counts()
    check_main_path(gpu, variant, counts, "rfft_leaf")

    # every block's stft against torch.fft.rfft of the same windowed frames
    window = torch.from_numpy((0.5 - 0.5 * np.cos(
        2 * math.pi * np.arange(frame) / frame)).astype(np.float32)).to(dev)
    worst = 0.0
    for i in range(len(store.blocks)):
        x = torch.from_numpy(
            np.frombuffer(store.read_block(i), np.float32).copy()).to(dev)
        got = torch.complex(*stft(x, frame, hop, device=dev))
        want = torch.fft.rfft(x.unfold(-1, frame, hop) * window, dim=-1)
        check(bool(torch.isfinite(got).all()), f"{variant} block {i}: "
              f"non-finite stft")
        e = rel_err(got, want)
        check(e < TOL, f"{variant} block {i}: stft {e} vs torch.fft.rfft")
        worst = max(worst, e)
        del x, got, want

    # step 3: the merged power spectrogram finds the tones and the chirp
    nbytes = job.merge(work / "spectrogram.bin")
    n_bins = frame // 2 + 1
    spec = np.fromfile(work / "spectrogram.bin", np.float32).reshape(-1,
                                                                     n_bins)
    found = np.sort(np.argsort(spec.mean(axis=0))[-3:]) * SR / frame
    for f, hz in zip(found, sorted(TONES_HZ)):
        check(abs(f - hz) < SR / frame + 1,
              f"{variant}: tone {hz} Hz found at {f} Hz")
    per_block = spec.shape[0] // len(store.blocks)
    peak = int(spec[:, n_bins // 2:].sum(axis=1).argmax())
    block_samples = store.block_bytes // 4
    chirp_s = ((peak // per_block) * block_samples
               + (peak % per_block) * hop) / SR
    expected_s = store.total_bytes // 4 // 2 / SR
    check(abs(chirp_s - expected_s) < 1.0,
          f"{variant}: chirp at {chirp_s} s, expected {expected_s} s")
    summary = {"run": variant, "frame": frame, "hop": hop,
               "blocks": len(store.blocks), "job_s": job_s,
               "gb_per_s": store.total_bytes / job_s / 1e9,
               "merged_bytes": nbytes, "retries": stats.retries,
               "speculative": stats.speculative_launches,
               "launches": counts, "worst_block_rel_err": worst,
               "tones_hz": [float(f) for f in found], "chirp_s": chirp_s}
    print("spectrogram " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# phase 7: fft_conv against a float64 torch.fft convolution


def conv_checks(torch, dev, gpu: bool, cases) -> list:
    import numpy as np

    from repro_torch.core.spectral import fft_conv
    from repro_torch.kernels.fft import plan as kplan

    rng = np.random.default_rng(1)
    out = []
    for batch, t, tk in cases:
        x = torch.from_numpy(rng.standard_normal((batch, t),
                                                 dtype=np.float32)).to(dev)
        k = torch.from_numpy(rng.standard_normal(tk,
                                                 dtype=np.float32)).to(dev)
        reset_counts()
        got = fft_conv(x, k, device=dev)
        counts = read_counts()
        n = 1 << max(1, (t + tk - 1).bit_length())
        want = torch.fft.irfft(torch.fft.rfft(x.double(), n)
                               * torch.fft.rfft(k.double(), n), n)[..., :t]
        e = float((got.double() - want).abs().max() / want.abs().max())
        c = {"shape": [batch, t], "taps": tk, "n": n, "rel_err": e,
             "launches": counts}
        print("fft_conv " + json.dumps(c))
        check(e < TOL_CONV, f"fft_conv {c}")
        check(bool(torch.isfinite(got).all()), f"fft_conv {c}: non-finite")
        kernel = "rfft_leaf" if n // 2 <= kplan.MAX_LEAF else "matfft_cols"
        check_main_path(gpu, f"fft_conv n={n}", counts, kernel)
        out.append(c)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU through the plain versions "
                         "(checks control flow; prints no result line)")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    gpu = not args.rehearse
    if gpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    cfg = FULL if gpu else REHEARSE
    dev = torch.device("cuda", 0) if gpu else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    from repro_torch.core.pipeline import BlockStore
    from repro_torch.kernels import build

    # phase 1: device
    smi = device_line() if gpu else "cpu (rehearsal)"
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build
    if gpu:
        t0 = time.monotonic()
        reports = build.build_all()
        print(f"build: {time.monotonic() - t0:.3f} s")
        for name, log in reports.items():
            for line in log.splitlines():
                if any(k in line for k in ("registers", "Compiling entry",
                                           "spill", "smem")):
                    print(f"ptxas[{name}] {line.strip()}")

    # phase 3: kernels against plain and torch.fft, timed
    checks, inv, timing = kernel_checks(torch, dev, cfg, gpu)

    # phases 4-5: the main path, one run per K1/K2 variant, one past
    # MAX_LEAF**2 and two through K4
    work_root = ROOT / "build" / "smoke"
    shutil.rmtree(work_root, ignore_errors=True)
    device_arg = ["--device", "cuda" if gpu else "cpu"]
    launches, runs, spectrograms = {}, [], []
    try:
        for name, kernel, job_args in cfg["runs"]:
            work = work_root / name.replace("/", "_")
            reset_counts()
            report = run_job([*job_args, "--pipelined", *device_arg,
                              "--work-dir", str(work)])
            counts = read_counts()
            fft_len = int(job_args[job_args.index("--fft-len") + 1])
            worst = check_job_output(torch, dev, work, fft_len)
            summary = {"run": name, "args": job_args,
                       "job_s": report["job_s"],
                       "overlap_x": report["overlap_x"],
                       "gb_per_s": report["gb_per_s"],
                       "stage_s": report["stage_s"],
                       "batches": report["batches"],
                       "blocks": report["blocks"], "launches": counts,
                       "worst_block_rel_err": worst}
            print("main path " + json.dumps(summary))
            runs.append(summary)
            check_main_path(gpu, name, counts, kernel)
            launches[name] = counts[kernel]
            shutil.rmtree(work, ignore_errors=True)

        # serial against pipelined, bitwise
        merged = {}
        for mode in ("serial", "pipelined"):
            work = work_root / f"bitwise_{mode}"
            extra = ["--pipelined"] if mode == "pipelined" else []
            report = run_job([*cfg["serial"], *extra, *device_arg,
                              "--work-dir", str(work)])
            merged[mode] = (work / "merged.bin").read_bytes()
            print(f"bitwise {mode}: job_s {report['job_s']}, "
                  f"batches {report['batches']}, blocks {report['blocks']}")
        equal = merged["serial"] == merged["pipelined"]
        print(f"serial vs pipelined merged outputs: "
              f"{'bitwise equal' if equal else 'DIFFERENT'} "
              f"({len(merged['serial'])} bytes)")
        check(equal, "serial and pipelined outputs differ")
        del merged

        # phase 6: the spectrogram job over a real capture, once per frame
        t0 = time.monotonic()
        capture = synth_capture(torch, dev, cfg["capture_samples"])
        store = BlockStore(work_root / "capture",
                           block_bytes=4 * cfg["block_samples"])
        store.put_bytes(capture)
        del capture
        print(f"capture: {cfg['capture_samples']} samples at {SR} Hz in "
              f"{len(store.blocks)} blocks, set up in "
              f"{time.monotonic() - t0:.3f} s")
        for variant, frame, hop in cfg["spectrograms"]:
            work = work_root / f"spectrogram_{frame}"
            summary = spectrogram_run(torch, dev, gpu, store, work, variant,
                                      frame, hop)
            spectrograms.append(summary)
            launches[variant] = summary["launches"]["rfft_leaf"]
            shutil.rmtree(work, ignore_errors=True)
    finally:
        shutil.rmtree(work_root, ignore_errors=True)

    # phase 7: fft_conv
    conv = conv_checks(torch, dev, gpu, cfg["conv"])

    if not gpu:
        print(f"rehearsal passed in {time.monotonic() - t_start:.1f} s")
        return 0

    # phase 8: the kernels line
    kernels = kernel_line(timing, launches)
    result = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "checks": checks,
              "batch_invariance": inv, "main_path": runs,
              "spectrograms": spectrograms, "fft_conv": conv,
              "kernels": kernels, "timing": timing,
              "seconds": time.monotonic() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(f"seconds: {result['seconds']:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
