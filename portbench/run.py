#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload paper_c2c1024.device --seed 7 \\
        --seconds 10 --trace 0

Runs from the root of a checkout that holds the program (src/repro_torch)
on a machine with the cell's chips, and prints one JSON line as the last
line of its standard output. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones, read from a `torch.profiler`
trace of a fixed number of calls after the timed window. The numbers that
decide ``correct`` end both standard error and the line (``compared``).

A cell on more than one chip runs one process a chip: this one is rank 0
and prints the line; before its own imports it starts the others
(``--rank r --port p``), which join a process group at
tcp://localhost:<p>, and it waits for them.
"""

import time

T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# every build and kernel cache inside the checkout, at fixed paths: only a
# checkout's first run compiles
os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import ranks  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def chips(workload: str) -> int:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next((int(w["chips"]) for w in bench["workloads"]
                 if w["name"] == workload), 1)


def measure(args, port: int) -> tuple[int, str | None]:
    """This process's rank of the run: its exit code, and on rank 0 the
    result line."""
    import torch

    from portbench import harness

    print(f"imports {time.perf_counter() - T0:.3f} s", file=sys.stderr)
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2, None
    device = torch.device("cuda", args.rank)

    def run(steer=None):
        return harness.run_rank(cell, args.seed, args.seconds,
                                bool(args.trace), device, args.rank,
                                cell.chips, steer, T0)

    if cell.chips == 1:
        per_rank = [run()]
    else:
        per_rank = harness.in_group(args.rank, cell.chips, port, device, run)
    if args.rank:
        return 0, None
    line = harness.result(cell, per_rank, bool(args.trace), device)
    found = harness.forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 3, None
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0, json.dumps(line)


def main(argv=None) -> int:
    args = parse(argv)
    child = [sys.executable, __file__, "--workload", args.workload,
             "--seed", str(args.seed), "--seconds", str(args.seconds),
             "--trace", str(args.trace)]
    rc, line = ranks.run_world(child, args.rank, args.port,
                               chips(args.workload), BUILD / "portbench",
                               lambda port: measure(args, port))
    if rc == 0 and line is not None:
        print(line)
    return rc


if __name__ == "__main__":
    sys.exit(main())
