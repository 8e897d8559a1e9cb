"""The analytic cost records of the paper's workload on a production mesh.

    PYTHONPATH=src python -m repro_torch.launch.fft_dryrun [--mesh multi_pod]

One JSON record a variant, planned for a 256-rank (16, 16) ``("data",
"model")`` mesh or, with ``--mesh multi_pod``, a 512-rank (2, 16, 16)
``("pod", "data", "model")`` mesh, the JAX package's production meshes:

  segmented       the paper's map-only regime: a batch of independent FFTs,
                  no collective
  dist_base       the 1-D distributed four-step, natural order, the twiddle
                  unfused
  dist_fused      the twiddle fused into the leaf kernel's store
  dist_transposed natural_order=False: exchange #3 skipped
  pencil2d        a 2-D image, rows sharded, one exchange leg
  pencil3d        a 3-D volume over the last two mesh dims, two legs (its
                  ``n_exchanges`` and ``plan_per_leg_collective_bytes``)
  dist_overlap{k}_analytic  the chunked exchange engine's hidden bytes
  ooc_2^K_analytic          the out-of-core factorization at the terabyte
                  point and the seconds of its traffic at `DISK_MB_S`

Nothing is built and nothing runs: the plans come from `repro_torch.fft.plan`
on `ShapeMesh`, a mesh of shape only (no process group, no card; a plan's
tables and kernels are built at its first execute, which never comes), and
the records read their cost model (`plan_flops`, `plan_hbm_bytes`,
`plan_collective_bytes`, `plan_exposed_collective_bytes`). ``compute_s``,
``memory_s`` and ``collective_s`` are one card's share of that work (each
placement splits it evenly over the ranks) at the H100's rates below, and
``bound`` names the largest. The JAX package's records also carry XLA's
compiled costs (``flops``, ``bytes``, ``temp_bytes``, ``a2a_bytes``, the
HLO collective counts); PyTorch compiles no such program, so these records
have none. ``--tune`` is refused: the tuner's wisdom key fingerprints the
mesh by its process group's world size and backend, and a plan of shape
only has no group.
"""

from __future__ import annotations

import argparse
import json
import repro_torch.fft as fft_api
from repro_torch.core.fft.distributed import plan_distributed
from repro_torch.core.pipeline.testing import DISK_MB_S
from repro_torch.launch.mesh import MESHES, ShapeMesh

# NVIDIA H100 SXM datasheet: 67 TFLOP/s in float32 outside the tensor cores
# (the kernels' arithmetic) and 3.35 TB/s of HBM3
F32_FLOPS_S = 67e12
HBM_BYTES_S = 3.35e12
# the link a card's exchange traffic leaves by: a 256- or 512-rank mesh spans
# 32 or 64 eight-card nodes, so all but 7 of a card's peers sit across the
# network, one 400 Gb/s NDR InfiniBand port a card (NVIDIA DGX H100
# datasheet: 8 ConnectX-7 ports for 8 cards). NVLink 4 inside a node (900
# GB/s a card, both directions) is not what bounds it
NET_BYTES_S = 400e9 / 8

def record(plan, name: str) -> dict:
    """One variant's cost model, and one card's seconds at the H100's
    rates."""
    d = plan.num_devices
    rec = {
        "name": name,
        "plan_flops": plan.flops,
        "plan_hbm_bytes": plan.hbm_bytes,
        "plan_collective_bytes": plan.collective_bytes,
        "plan_exposed_collective_bytes": plan.exposed_collective_bytes,
        "devices": d,
        "compute_s": plan.flops / d / F32_FLOPS_S,
        "memory_s": plan.hbm_bytes / d / HBM_BYTES_S,
        "collective_s": plan.collective_bytes / d / NET_BYTES_S,
    }
    rec["bound"] = max(("compute_s", "memory_s", "collective_s"),
                       key=lambda k: rec[k])
    return rec


def records(args) -> list:
    shape, names = MESHES[args.mesh]
    mesh = ShapeMesh(shape, names)
    axes = names
    d = mesh.size()
    recs = []

    p = fft_api.plan(kind="c2c", n=args.seg_len,
                     batch_shape=(args.seg_batch,), mesh=mesh,
                     placement="segmented", axes=axes)
    recs.append(record(p, "segmented"))

    for name, kw in (
            ("dist_base", dict(natural_order=True, fuse_twiddle=False)),
            ("dist_fused", dict(natural_order=True, fuse_twiddle=True)),
            ("dist_transposed", dict(natural_order=False, fuse_twiddle=True))):
        p = fft_api.plan(kind="c2c", n=args.n, mesh=mesh,
                         placement="distributed", axes=axes, overlap="off",
                         **kw)
        recs.append(record(p, name))

    p = fft_api.plan(kind="c2c", shape=tuple(args.n2d), mesh=mesh,
                     placement="distributed", axes=axes, overlap="off")
    recs.append(record(p, "pencil2d"))

    p = fft_api.plan(kind="c2c", shape=tuple(args.n3d), mesh=mesh,
                     placement="distributed", axes=axes[-2:], overlap="off")
    rec = record(p, "pencil3d")
    rec["n_exchanges"] = p.dist.n_exchanges
    rec["plan_per_leg_collective_bytes"] = list(p.per_leg_collective_bytes)
    recs.append(rec)

    dp = plan_distributed(args.n, d)
    chunks = min(4, dp.n1 // dp.d, dp.n2 // dp.d)  # valid for any --n
    p = fft_api.plan(kind="c2c", n=args.n, mesh=mesh,
                     placement="distributed", axes=axes, natural_order=True,
                     fuse_twiddle=True, overlap=chunks)
    hidden = p.collective_bytes - p.exposed_collective_bytes
    recs.append({
        "name": f"dist_overlap{chunks}_analytic",
        "analytic_only": True,
        "plan_collective_bytes": p.collective_bytes,
        "plan_exposed_collective_bytes": p.exposed_collective_bytes,
        "plan_hidden_collective_bytes": hidden,
        "collective_s": p.collective_bytes / d / NET_BYTES_S,
        "exposed_collective_s": p.exposed_collective_bytes / d / NET_BYTES_S,
        "predicted_overlap_win_s": hidden / d / NET_BYTES_S,
    })

    f = fft_api.factor_out_of_core(1 << args.ooc_log2_n,
                                   args.ooc_budget_mb << 20)
    recs.append({
        "name": f"ooc_2^{args.ooc_log2_n}_analytic",
        "analytic_only": True,
        **f.as_dict(),
        "budget_bytes": args.ooc_budget_mb << 20,
        "disk_model_mb_s": DISK_MB_S,
        "disk_model_s": f.io_bytes / (DISK_MB_S * (1 << 20)),
    })
    return recs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 28,
                    help="global FFT length (distributed variants)")
    ap.add_argument("--n2d", type=int, nargs=2, default=[1 << 14, 1 << 14],
                    help="global image shape (pencil2d variant)")
    ap.add_argument("--n3d", type=int, nargs=3,
                    default=[1 << 10, 1 << 10, 1 << 8],
                    help="global volume shape (pencil3d variant; axes 0 "
                         "and 1 shard over the last two mesh dims)")
    ap.add_argument("--tune", action="store_true",
                    help="refused here: the tuner needs a process group")
    ap.add_argument("--seg-batch", type=int, default=1 << 15)
    ap.add_argument("--seg-len", type=int, default=4096)
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod"])
    ap.add_argument("--ooc-log2-n", type=int, default=34,
                    help="out-of-core analytic record: log2 points")
    ap.add_argument("--ooc-budget-mb", type=int, default=1024,
                    help="out-of-core analytic record: budget in MiB")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.tune:
        ap.error("--tune needs a process group: the tuner's wisdom key "
                 "fingerprints the mesh by its world size and backend "
                 "(fft/tuner.py mesh_fingerprint), and this dryrun plans "
                 "on a mesh of shape only")
    recs = records(args)
    for r in recs:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"n": args.n, "mesh": args.mesh, "variants": recs}, f,
                      indent=1)
    return recs


if __name__ == "__main__":
    main()
