#!/usr/bin/env python3
"""Readings of a cell's numbers for its limits: the program's and the
control's (the reference computed in TF32, put in the program's place), on
the cell's inputs at its own size, seed by seed.

    python3 portbench/control.py --workload paper_c2c1024.host --seeds 1 2 3

Prints one JSON line a seed: ``{"seed", "program": {...}, "control":
{...}}``, each the numbers `check` compares for the first operand of the
pool. The program's numbers come from one call of the timed path at the
cell's size, outside any window. A cell on more chips runs one process a
chip, started as run.py starts them (`ranks.run_world`). The benchmark's
own runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import harness, ranks  # noqa: E402


def readings(cell, seed: int, device, rank: int = 0, world: int = 1) -> dict:
    """The program's and the control's numbers for one seed."""
    drv = harness.driver(cell, harness.Context(cell.config, cell.traffic,
                                               seed, device, rank, world))
    out = drv.call(0)
    if hasattr(drv, "complete"):
        out = drv.complete(out)
    program = drv.check(0, out)
    del out
    return {"seed": seed, "program": program, "control": drv.control(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", args.rank)

    def body(port):
        def job(steer=None):
            return [readings(cell, seed, device, args.rank, cell.chips)
                    for seed in args.seeds]
        if cell.chips == 1:
            return 0, job()
        return 0, harness.in_group(args.rank, cell.chips, port, device,
                                   job)[0]

    child = [sys.executable, __file__, "--workload", args.workload,
             "--seeds", *map(str, args.seeds)]
    rc, lines = ranks.run_world(child, args.rank, args.port, cell.chips,
                                ROOT / "build" / "portbench", body)
    if rc == 0 and args.rank == 0:
        for line in lines:
            print(json.dumps(line))
    return rc


if __name__ == "__main__":
    sys.exit(main())
