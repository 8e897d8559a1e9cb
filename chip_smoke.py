#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py             # on a machine with an H100
    python3 chip_smoke.py --rehearse  # tiny sizes, CPU, plain versions

Phases (any failed check exits non-zero):

  1. device: the card's name and power limit (nvidia-smi), CUDA version;
  2. build: compile every kernel from csrc/ with nvcc, print what ptxas
     reports (registers, shared memory, spills);
  3. kernels against their plain PyTorch versions and torch.fft on the card
     (K1 at n = 256, 1024, MAX_LEAF with and without the epilogue; K2 at
     L = 256, 1024, row- and column-major, with the epilogue; one error
     formula), batch invariance (a row alone == the row inside a
     32768-row batch), and each variant's main-path case timed beside its
     bound, its plain version and torch.fft (a yardstick only);
  4. main path: the map-only FFT job (`repro_torch.launch.fft_job`) driven
     pipelined through its CLI entry point, once per kernel variant and
     once past MAX_LEAF**2 (three levels), each with the launch counts
     zeroed just before and read just after: every output block within
     5e-6 of torch.fft.fft of its input block, the kernel launched, the
     plain versions never called;
  5. serial against pipelined: the merged outputs equal bitwise;
  6. the `kernels` JSON line: phase 3's numbers and phase 4's launches.

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

# the Pallas sites each kernel variant replaces
REPLACES = {
    "matfft/direct": "src/repro/kernels/fft/matfft.py:234",
    "matfft/four_step": "src/repro/kernels/fft/matfft.py:252",
    "matfft_cols/direct": "src/repro/kernels/fft/matfft.py:419",
    "matfft_cols/four_step": "src/repro/kernels/fft/matfft.py:438",
}

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
    ],
    # serial vs pipelined: 4 blocks of the first run's configuration
    "serial": ["--fft-len", "1024", "--size-mb", "256",
               "--segments-per-block", "8192", "--coalesce", "4"],
    "points": 1 << 25,      # complex points per kernel check and timing
    "batch_rows": 32768,    # batch of the invariance check
    "reps": 10,
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
    ],
    "serial": ["--fft-len", "1024", "--size-mb", "1",
               "--segments-per-block", "32", "--coalesce", "4"],
    "points": 1 << 15,
    "batch_rows": 64,
    "reps": 1,
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
    """(variant, wrapper, shape, options, timed): K1 at n = 256, 1024,
    MAX_LEAF with and without the periodic epilogue, K2 at L = 256, 1024
    row- and column-major with the epilogue. ``timed`` marks each
    variant's main-path case: the level-0 batch (coalesce 4 x 8192
    segments of 1024, or 4 x 32768 of 256) and the level-1 first pass
    (2^20 points: 2 blocks x 16 segments as (32, 1024, 1024); 2^16: 4 x 128
    as (512, 256, 256)), all at 2^25 points."""
    points = cfg["points"]
    cases = []
    for n in (256, 1024, max_leaf):
        variant = "matfft/direct" if n <= 256 else "matfft/four_step"
        for period in (None, 64):
            cases.append((variant, "matfft", (points // n, n),
                          {"period": period},
                          period is None and n in (256, 1024)))
    for L in (256, 1024):
        variant = "matfft_cols/direct" if L <= 256 else \
            "matfft_cols/four_step"
        for out_major in ("row", "col"):
            cases.append((variant, "matfft_cols",
                          (max(points // (L * L), 1), L, L),
                          {"out_major": out_major}, out_major == "row"))
    return cases


def kernel_checks(torch, dev, cfg, gpu: bool) -> tuple[list, dict, dict]:
    import numpy as np

    from repro_torch.kernels.fft import matfft as km
    from repro_torch.kernels.fft import plan as kplan

    rng = np.random.default_rng(0)
    reps = cfg["reps"]

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
        xr, xi = planes(shape)
        xc = torch.complex(xr, xi)
        if kernel == "matfft":
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
        else:
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
        got = run() if gpu else plain()
        ref = plain()
        got_c = torch.complex(*got)
        max_abs = float((got_c - torch.complex(*ref)).abs().max())
        c = {"variant": variant, "shape": list(shape), **opts,
             "epilogue": list(epi[0].shape) if epi is not None else None,
             "max_abs_err": max_abs,
             "rel_err_plain": max_abs / float(torch.complex(*ref).abs().max()),
             "rel_err_torch_fft": rel_err(got_c, torch.complex(*want))}
        print("check " + json.dumps(c))
        checks.append(c)
        check(c["rel_err_plain"] < TOL and c["rel_err_torch_fft"] < TOL,
              f"kernel disagrees: {c}")
        del got, ref, got_c, want, y
        if gpu and timed:
            # plain, kernel, kernel, plain: one card, one call
            t_plain = [timed_ms(torch, plain, reps)]
            t_kernel = [timed_ms(torch, run, reps), timed_ms(torch, run, reps)]
            t_plain.append(timed_ms(torch, plain, reps))
            # each input read once (planes, leaf tables, epilogue), each
            # output written once; 5 n log2 n flops a row, 6 a point for
            # the epilogue's complex product
            tables = km.leaf_tables(n, dev)
            nbytes = (rows * kplan.fft_hbm_bytes(n)
                      + sum(t.numel() * 4 for t in tables)
                      + (2 * epi[0].numel() * 4 if epi is not None else 0))
            flops = rows * (5.0 * n * math.log2(n)
                            + (6.0 * n if epi is not None else 0.0))
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_flops = flops / F32_FLOPS_S * 1e3
            timing[variant] = {
                "case": c, "bytes": nbytes, "flops": flops,
                "max_abs_err": max_abs, "max_rel_err": c["rel_err_plain"],
                "ms": min(t_kernel), "ms_runs": t_kernel,
                "plain_ms": min(t_plain), "plain_ms_runs": t_plain,
                "library_ms": timed_ms(torch, lib, reps),
                "bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
        del xr, xi, xc, epi

    # batch invariance: row 0 alone == row 0 inside the big batch, bitwise
    fn = km.matfft if gpu else km.matfft_plain
    xr, xi = planes((cfg["batch_rows"], 1024))
    alone = fn(xr[:1].contiguous(), xi[:1].contiguous())
    batch = fn(xr, xi)
    invariant = (torch.equal(alone[0][0], batch[0][0])
                 and torch.equal(alone[1][0], batch[1][0]))
    print(f"batch invariance (1 row vs {cfg['batch_rows']} rows, n=1024): "
          f"{'bitwise equal' if invariant else 'DIFFERENT'}")
    if gpu:  # the plain version's matmul need not be batch invariant
        check(invariant, "row 0 alone differs from row 0 in the batch")
    return checks, {"batch_invariant": invariant}, timing


def kernel_line(timing: dict, launches: dict) -> list:
    """The `kernels` entries: measured numbers, the main path's launch
    counts and the bound; each variant's shape, bytes and flops stay in
    chiprun_out/chip_smoke.json."""
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/matfft.cu",
             "replaces": REPLACES[name], "launches": launches[name],
             **{k: t[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                  "ms_runs", "plain_ms", "plain_ms_runs",
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
    from repro_torch.kernels import build
    from repro_torch.kernels.fft import matfft as km

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

    # phases 4-5: the main path, one run per kernel variant and one past
    # MAX_LEAF**2
    work_root = ROOT / "build" / "smoke"
    shutil.rmtree(work_root, ignore_errors=True)
    device_arg = ["--device", "cuda" if gpu else "cpu"]
    launches, runs = {}, []
    try:
        for name, kernel, job_args in cfg["runs"]:
            work = work_root / name.replace("/", "_")
            km.reset_counts()
            report = run_job([*job_args, "--pipelined", *device_arg,
                              "--work-dir", str(work)])
            counts = {"matfft": km.matfft.launches,
                      "matfft_cols": km.matfft_cols.launches,
                      "plain": km.matfft_plain.calls
                      + km.matfft_cols_plain.calls}
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
            if gpu:
                check(counts[kernel] > 0, f"{name}: {kernel} never launched")
                check(counts["plain"] == 0,
                      f"{name}: a plain version ran on the main path")
            else:
                check(counts["plain"] > 0, "rehearsal: plain path not run")
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
    finally:
        shutil.rmtree(work_root, ignore_errors=True)

    if not gpu:
        print(f"rehearsal passed in {time.monotonic() - t_start:.1f} s")
        return 0

    # phase 6: the kernels line
    kernels = kernel_line(timing, launches)
    result = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "checks": checks,
              "batch_invariance": inv, "main_path": runs,
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
