"""The paper's workload as a launcher: block-distributed FFT over a file.

  PYTHONPATH=src python -m repro_torch.launch.fft_job --size-mb 64 \\
      --fft-len 1024 --workers 4 --pipelined --coalesce 4

Mirrors the paper's Figure 1 flow: copy-in (split into blocks) -> map-only
batched FFT per block -> direct output writes -> getmerge. Two execution
modes over the same store:

  * serial (default): the classic one-thread-per-block map task, each
    attempt doing read -> decode -> H2D -> execute -> sync -> D2H ->
    encode -> write in sequence;
  * --pipelined: the overlapped stream executor (core/pipeline/stream.py)
    with ``--coalesce`` same-shaped blocks per device batch and an
    ``--inflight`` launch window, so device compute hides behind block I/O.

With ``--out-of-core`` the job is instead ONE 2^log2-n-point c2c whose
operand lives in the store, streamed through two bounded passes under
``--budget-mb`` of host working set (core/fft/outofcore.py).

``--tune`` plans through the measuring autotuner (`repro_torch.fft.tuner`):
the serial job's block plan, or the out-of-core panel height. The winner is
kept as wisdom in ``--wisdom-path``, so a second run measures nothing; the
report's ``tuner`` entry carries the tuner's counters.

The transforms run on the CUDA card (``--device cuda``, the default; no
card is an error) or, with ``--device cpu``, through the kernels' plain
PyTorch versions. Both modes report per-stage clocks
(read/h2d/compute/d2h/write), plus the paper's Amdahl/runtime-model
prediction.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

import repro_torch.fft as fft_api
from repro_torch.core.amdahl import (ClusterModel, calibrate_unit_time,
                                     fit_parallel_fraction)
from repro_torch.core.pipeline import (BlockStore, JobConfig, MapOnlyJob,
                                       SegmentFFTTransform, block_of_segments,
                                       segments_of_block)
from repro_torch.core.pipeline.records import segment_block_bytes
from repro_torch.fft.spec import resolve_device

STAGES = ("read", "h2d", "compute", "d2h", "write")
INGEST_POINTS = 1 << 22  # complex points drawn per slice of the operand


class _TimedStore:
    """Serial-mode shim: clocks block file I/O into the shared stage dict
    so the serial path's "read"/"write" totals cover the same work as the
    stream executor's (file I/O happens inside MapOnlyJob._attempt, out of
    map_fn's reach)."""

    def __init__(self, store: BlockStore, add):
        self._store = store
        self._add = add

    def __getattr__(self, name):
        return getattr(self._store, name)

    def read_block(self, index: int, verify: bool = True) -> bytes:
        t0 = time.monotonic()
        data = self._store.read_block(index, verify)
        self._add("read", t0)
        return data

    def write_output_block(self, out_dir, index: int, data) -> None:
        t0 = time.monotonic()
        self._store.write_output_block(out_dir, index, data)
        self._add("write", t0)


def serial_map_fn(fft_len: int, impl: str, add, verify: str = "off",
                  device="cuda", tune: bool = False, wisdom_path=None):
    """The synchronous per-block map task, with per-stage clocks.

    Stage names match the stream executor's so the two paths are
    comparable ("read"/"write" also accumulate the block file I/O, via
    `_TimedStore`).
    """
    device = resolve_device(device)

    def map_fn(data: bytes, idx: int) -> bytes:
        t = time.monotonic()
        re, im = segments_of_block(data, fft_len)
        t = add("read", t)
        re = torch.from_numpy(re).to(device)
        im = torch.from_numpy(im).to(device)
        t = add("h2d", t)
        # every same-shaped block hits the process-level plan cache: the
        # tables are uploaded once, the cufftPlanMany amortization
        p = fft_api.plan(kind="c2c", n=fft_len, batch_shape=re.shape[:-1],
                         impl=impl, verify=verify, device=device, tune=tune,
                         wisdom_path=wisdom_path)
        yr, yi = p.execute(re, im)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the serial path's per-block sync
        t = add("compute", t)
        yr, yi = yr.cpu().numpy(), yi.cpu().numpy()
        t = add("d2h", t)
        out = block_of_segments(yr, yi)
        add("write", t)
        return out

    return map_fn


def parseval_verify_fn(fft_len: int):
    """Serial-mode ABFT hook (`JobConfig.verify_fn`): block-aggregate
    Parseval over the map output — every segment is length fft_len, so
    the whole block must carry fft_len x its input energy."""
    from repro_torch.core.resilience import verify as abft

    def verify_fn(data: bytes, out: bytes, index: int) -> None:
        re, im = segments_of_block(data, fft_len)
        yr, yi = segments_of_block(out, fft_len)
        abft.check_parseval(abft.energy(re, im), abft.energy(yr, yi),
                            fft_len, "f32", site="maponly.attempt",
                            index=index)

    return verify_fn


def run_job(store: BlockStore, out_dir, *, fft_len: int, impl: str,
            cfg: JobConfig, pipelined: bool, verify: str = "off",
            device="cuda", tune: bool = False, wisdom_path=None):
    """Run the FFT job serial or pipelined; returns (job, stats, stage_s)."""
    if pipelined:
        job = MapOnlyJob(store, out_dir, config=cfg, pipelined=True,
                         transform=SegmentFFTTransform(
                             fft_len, impl=impl, verify=verify,
                             device=device))
        stats = job.run()
        return job, stats, dict(stats.stage_s)
    stage_s = {k: 0.0 for k in STAGES}
    lock = threading.Lock()  # map tasks run on the job's worker pool

    def add(stage: str, t0: float) -> float:
        now = time.monotonic()
        with lock:
            stage_s[stage] += now - t0
        return now

    if verify != "off":
        cfg = replace(cfg, verify_fn=parseval_verify_fn(fft_len))
    job = MapOnlyJob(_TimedStore(store, add), out_dir,
                     serial_map_fn(fft_len, impl, add, verify, device, tune,
                                   wisdom_path),
                     config=cfg)
    stats = job.run()
    return job, stats, stage_s


def operand_chunks(n: int, seed: int):
    """The out-of-core operand, ``default_rng(seed).standard_normal((n,
    2))`` as float32 bytes, drawn in slices of INGEST_POINTS points: the
    generator yields the same values sliced as in one draw, and copy-in
    never holds the float64 draw of the whole operand."""
    rng = np.random.default_rng(seed)
    for start in range(0, n, INGEST_POINTS):
        rows = min(INGEST_POINTS, n - start)
        yield rng.standard_normal((rows, 2)).astype(np.float32)


def run_out_of_core(args, device: torch.device) -> dict:
    """The >RAM workload: one giant 1-D c2c streamed through the store.

    Ingests 2^log2_n random complex64 samples as a `BlockStore`, builds
    the ``placement="out_of_core"`` plan under ``--budget-mb``, executes
    both streamed passes (crash-resume: re-running the same --work-dir
    picks up from the phase manifests), and getmerges the spectrum.
    """
    work = Path(args.work_dir)
    n = 1 << args.log2_n
    budget = args.budget_mb << 20
    factors = fft_api.factor_out_of_core(n, budget)
    # one job's panel per block, capped at 4 MiB: both are powers of two,
    # so the block always tiles the panel (and an ingest slice)
    block_bytes = min(factors.pass1_panel_bytes, 1 << 22)

    t0 = time.monotonic()
    store = BlockStore(work / "in", block_bytes=block_bytes,
                       replication=args.replication)
    store.put_chunks(operand_chunks(n, args.seed))
    t_put = time.monotonic() - t0

    injector = None
    if args.faults:
        from repro_torch.core.resilience import FaultInjector, FaultPlan
        injector = FaultInjector(
            FaultPlan.parse(args.faults, num_blocks=len(store.blocks)))
        store.injector = injector
    cfg = JobConfig(readers=args.readers, writers=args.writers,
                    inflight=args.inflight, speculation=False,
                    max_retries=args.max_retries, injector=injector)

    plan = fft_api.plan(kind="c2c", n=n, placement="out_of_core",
                        store=store, work_dir=work / "ooc", impl=args.impl,
                        budget_bytes=budget, job_config=cfg,
                        verify=args.verify, device=device, tune=args.tune,
                        wisdom_path=args.wisdom_path)
    t0 = time.monotonic()
    stats = plan.execute()
    t_job = time.monotonic() - t0
    t0 = time.monotonic()
    nbytes = plan.merge(work / "merged.bin")
    t_merge = time.monotonic() - t0
    from repro_torch.core.resilience import events
    return {
        "mode": "out_of_core",
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "verify": args.verify,
        "corruption_detected": len(events("verify_failed")),
        "corruption_recomputed": stats.pass1.retries + stats.pass2.retries,
        "factors": plan.factors.as_dict(),
        "block_bytes": block_bytes,
        "budget_bytes": budget,
        "operand_over_budget_x": factors.operand_bytes / budget,
        "copy_in_s": t_put,
        "job_s": t_job,
        "merge_s": t_merge,
        "merged_bytes": nbytes,
        "stats": stats.as_dict(),
        "store": store.stats.as_dict(),
        "faults": injector.summary() if injector is not None else None,
        "plan_cache": fft_api.cache_info(),
        "tuner": _tuner_stats(args.tune),
    }


def _tuner_stats(tune: bool):
    """The tuner's counters for the report; None without --tune."""
    if not tune:
        return None
    from repro_torch.fft import tuner
    return tuner.tune_stats()


def main(argv=None) -> dict:
    """Run the job from command-line arguments; prints the JSON report and
    returns it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--size-mb", type=int, default=64)
    ap.add_argument("--fft-len", type=int, default=1024)
    ap.add_argument("--segments-per-block", type=int, default=2048)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--impl", default="matfft",
                    choices=["matfft", "stockham", "ref"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the CUDA card (default; no card is an "
                         "error) or the kernels' plain versions on the CPU")
    ap.add_argument("--work-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_fft_job"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipelined", action="store_true",
                    help="overlapped stream executor instead of the "
                         "serial per-block map loop")
    ap.add_argument("--coalesce", type=int, default=4,
                    help="same-shaped blocks per device batch (pipelined)")
    ap.add_argument("--inflight", type=int, default=2,
                    help="launched-but-unrealized batch window (pipelined)")
    ap.add_argument("--readers", type=int, default=2,
                    help="prefetch/decode threads (pipelined)")
    ap.add_argument("--writers", type=int, default=2,
                    help="writeback threads (pipelined)")
    ap.add_argument("--replication", type=int, default=1,
                    help="block replicas kept in the store")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="per-block attempt budget")
    ap.add_argument("--faults", default=None,
                    help="deterministic fault schedule to replay "
                         "(core/resilience/faults.py FaultPlan.parse spec: "
                         "'seed=N,rate=R,sites=a+b', inline JSON, or "
                         "@file.json; add kind=corrupt for silent "
                         "bit-rot) — the report then carries retry, "
                         "repair, and injector stats")
    ap.add_argument("--verify", default="off",
                    choices=["off", "parseval", "abft"],
                    help="ABFT invariant verification (DESIGN.md §13): "
                         "parseval checks output energy per unit, abft "
                         "adds a linearity checksum row per batch; "
                         "detections quarantine-and-recompute through "
                         "the retry path and are counted in the report")
    ap.add_argument("--out-of-core", action="store_true",
                    help="run one 2^log2-n-point c2c whose operand lives "
                         "in the BlockStore, streamed under --budget-mb "
                         "(ignores the segment-batch options above)")
    ap.add_argument("--log2-n", type=int, default=20,
                    help="out-of-core transform size, log2 of points")
    ap.add_argument("--budget-mb", type=int, default=16,
                    help="out-of-core working-set budget in MiB")
    ap.add_argument("--tune", action="store_true",
                    help="measuring autotuner: pick the serial job's layout "
                         "(or the out-of-core panel height) "
                         "by measurement and keep the winner as wisdom, so "
                         "a later run measures nothing; the report carries "
                         "the tuner's counters")
    ap.add_argument("--wisdom-path", default=None,
                    help="wisdom file for --tune (default "
                         "~/.cache/repro_torch_fft/wisdom.json)")
    args = ap.parse_args(argv)
    if args.tune and args.pipelined and not args.out_of_core:
        ap.error("--tune plans the serial job's blocks or the out-of-core "
                 "panels; the pipelined stream plans its own batches")
    device = resolve_device(args.device)  # no card: fail before any work

    if args.out_of_core:
        report = run_out_of_core(args, device)
        print(json.dumps(report, indent=1))
        return report

    work = Path(args.work_dir)
    n_seg = args.size_mb * (1 << 20) // (8 * args.fft_len)
    rng = np.random.default_rng(args.seed)

    # --- copy-in (HDFS put) ---
    t0 = time.monotonic()
    sig = rng.standard_normal((n_seg, args.fft_len, 2)).astype(np.float32)
    store = BlockStore(work / "in", block_bytes=segment_block_bytes(
        args.fft_len, args.segments_per_block),
        replication=args.replication)
    store.put_bytes(sig.tobytes())
    del sig
    t_put = time.monotonic() - t0

    # --- optional deterministic chaos replay ---
    injector = None
    if args.faults:
        from repro_torch.core.resilience import FaultInjector, FaultPlan
        injector = FaultInjector(
            FaultPlan.parse(args.faults, num_blocks=len(store.blocks)))
        store.injector = injector

    # --- map-only FFT job ---
    cfg = JobConfig(workers=args.workers, readers=args.readers,
                    writers=args.writers, coalesce=args.coalesce,
                    inflight=args.inflight, max_retries=args.max_retries,
                    injector=injector)
    t0 = time.monotonic()
    job, stats, stage_s = run_job(store, work / "out", fft_len=args.fft_len,
                                  impl=args.impl, cfg=cfg,
                                  pipelined=args.pipelined,
                                  verify=args.verify, device=device,
                                  tune=args.tune,
                                  wisdom_path=args.wisdom_path)
    t_job = time.monotonic() - t0
    t0 = time.monotonic()
    nbytes = job.merge(work / "merged.bin")
    t_merge = time.monotonic() - t0

    # --- paper metrics ---
    # stage clocks are per-thread sums; in pipelined mode they run
    # concurrently, so these fractions are shares of total STAGE TIME
    # (thread-seconds of work), not a wall-clock split. The device side is
    # compute + d2h. Serial: compute is the host's time from the launch to
    # the device's synchronize, d2h the copy. Pipelined on a card: compute
    # is each batch's device time from its upload's start to its kernels'
    # end (CUDA events, read at realization), d2h the host's time in
    # realize's copies, its wait for the device left out; on the CPU,
    # compute is the host's time in the launch, which does the work. The
    # Amdahl model below calibrates on wall time (t_job) and is unaffected.
    fft_s = stage_s.get("compute", 0.0) + stage_s.get("d2h", 0.0)
    io_s = sum(v for k, v in stage_s.items()
               if k not in ("compute", "d2h"))
    p_frac = fit_parallel_fraction(io_s, fft_s)
    n = n_seg * args.fft_len
    unit = calibrate_unit_time(n, t_job, servers=1, cores=args.workers,
                               efficiency=1.0)
    model = ClusterModel(unit_time_s=unit)
    stage_total = sum(stage_s.values())
    from repro_torch.core.resilience import events
    report = {
        "mode": "pipelined" if args.pipelined else "serial",
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "verify": args.verify,
        "corruption_detected": len(events("verify_failed")),
        "corruption_recomputed": stats.retries,
        "size_mb": args.size_mb,
        "blocks": len(store.blocks),
        "copy_in_s": t_put,
        "job_s": t_job,
        "merge_s": t_merge,
        "merged_bytes": nbytes,
        "gb_per_s": nbytes / t_job / 1e9 if t_job else None,
        "stage_s": dict(stage_s),
        "stage_total_s": stage_total,
        # >1 means stages genuinely overlapped (wall < sum of stage time)
        "overlap_x": stage_total / t_job if t_job else None,
        "batches": stats.batches,
        "coalesced_blocks": stats.coalesced_blocks,
        "fft_fraction": p_frac,
        "io_fraction": 1 - p_frac,
        "attempts": stats.attempts,
        "speculative": stats.speculative_launches,
        "retries": stats.retries,
        "failed_blocks": stats.failed_blocks,
        "store": store.stats.as_dict(),
        "faults": injector.summary() if injector is not None else None,
        "predicted_s_8_workers": model.predict(n, 1, 8),
        "predicted_s_64_workers": model.predict(n, 8, 8),
        "plan_cache": fft_api.cache_info(),
        "tuner": _tuner_stats(args.tune),
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
