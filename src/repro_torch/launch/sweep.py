"""The dryrun sweep: every (arch x shape x mesh) cell as a subprocess,
the counterpart of the JAX package's ``repro/launch/sweep.py``.

Each cell runs `repro_torch.launch.dryrun` in its own process, so that a
cell that fails or hangs cannot take the sweep with it. A cell's record
already in ``--out`` is reused; a record that does not parse is deleted
and its cell run again. A cell that fails or runs past ``--timeout``
leaves an ``ok: false`` record with its ``wall_s``. One status line a
cell; exit 1 if any cell failed.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--out build/dryrun] \\
      [--meshes single_pod multi_pod] [--archs ...] [--shapes ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import MESHES
from repro_torch.launch.specs import SHAPES


def run_one(arch, shape, mesh, out_dir: Path, timeout_s: int) -> dict:
    out = out_dir / f"{arch}__{shape}__{mesh}.json"
    if out.exists():
        try:
            return json.loads(out.read_text())
        except json.JSONDecodeError:
            out.unlink()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", str(out)]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s)
        if out.exists():
            return json.loads(out.read_text())
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
               "error": f"exit={proc.returncode}",
               "stderr": proc.stderr[-2000:]}
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
               "error": f"timeout after {timeout_s}s"}
    rec["wall_s"] = round(time.monotonic() - t0, 1)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--meshes", nargs="*", default=["single_pod", "multi_pod"],
                    choices=list(MESHES))
    ap.add_argument("--archs", nargs="*", default=ARCHS, choices=ARCHS)
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES),
                    choices=list(SHAPES))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for mesh in args.meshes:
        for arch in args.archs:
            for shape in args.shapes:
                t0 = time.monotonic()
                rec = run_one(arch, shape, mesh, out_dir, args.timeout)
                status = ("SKIP" if rec.get("skipped")
                          else "ok" if rec.get("ok") else "FAIL")
                print(f"[{status:4s}] {mesh:10s} {arch:24s} {shape:12s} "
                      f"({time.monotonic() - t0:6.1f}s)", flush=True)
                results.append(rec)
    n_fail = sum(1 for r in results if not r.get("ok"))
    print(f"\n{len(results)} cells, {n_fail} failures")
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
