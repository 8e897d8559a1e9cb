"""The benchmark's harness: finds a cell's pieces by name, runs its closed
loop on this machine's chips, reads its metrics and decides `correct`.

Every piece is found by the names in BENCHMARK.json, so a later cell, traffic
mix or metric is new files and entries, never an edit here:

  configuration   the ``file`` its entry in ``configs`` names
  traffic mix     portbench/traffic/<traffic>.json: the ``entry`` that
                  drives it, ``inflight``, ``pool``, ``checked_calls``,
                  ``traced_calls``, ``warmup_calls`` and the ``limits`` of
                  the numbers compared
  traffic driver  portbench/entries/<entry>.py (`Driver`; its ``kind``,
                  c2c or r2c, is the transform the cell's work counts)
  every metric    portbench/metrics/<metric>.py (``read(run)``); a name
                  ``<metric>.<part>`` is the same reading under a name of
                  its own, for cells whose runs spread differently

The window is a closed loop that keeps ``inflight`` calls issued ahead of
the one the host waits for, as the paper's pipelined job does. A call's
output stays alive only until it completes, except for ``checked_calls``
calls at moments drawn from the seed, whose outputs are held to the
reference once the window has closed and the device's peak been read.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import importlib
import json
import random
import sys
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import torch

from portbench import trace, work

ROOT = Path(__file__).resolve().parents[1]
# top-level modules no run may hold: JAX and the JAX package (the port,
# ``repro_torch``, is compared by its whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list   # names of the end-to-end metrics this cell reports
    per_layer: list    # names of the per-layer metrics this cell reports
    units: dict        # every metric's unit, by name


@dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    rank: int = 0
    world: int = 1


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads(
            (root / "portbench" / "traffic" / f"{w['traffic']}.json")
            .read_text()),
        chips=int(w["chips"]),
        end_to_end=[m["name"] for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"] if applies(m, name)],
        units={m["name"]: m["unit"]
               for m in (*bench["end_to_end"], *bench["per_layer"])})


def driver(cell: Cell, ctx: Context):
    entry = importlib.import_module(f"portbench.entries.{cell.traffic['entry']}")
    return entry.Driver(ctx)


def reader(metric: str):
    base = metric.split(".")[0]
    return importlib.import_module(f"portbench.metrics.{base}").read


class Marker:
    """A point on the device's clock behind the work issued so far on
    ``stream`` (default: the current one); on an idle stream, the moment the
    host records it. On the CPU, where calls are synchronous, the host's
    clock."""

    def __init__(self, device: torch.device, stream=None):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(stream)
        else:
            self.t = time.perf_counter()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def ms_since(self, other: "Marker") -> float:
        if self.event is not None:
            return other.event.elapsed_time(self.event)
        return (self.t - other.t) * 1e3


def closed_loop(drv, inflight: int, device, *, seconds=None, calls=None,
                keep_at=(), steer=None, spans: bool = False) -> dict:
    """Issue calls, ``inflight`` ahead of the one waited for, for
    ``seconds`` on the host's clock or for ``calls`` calls. ``keep_at``:
    offsets in seconds at which the next call's output is kept. ``steer``
    (rank 0 decides for every rank): ``(go, keep) -> (go, keep)``.
    ``spans`` records the benchmark's call spans for the profiler.

    A call's latency runs from its issue, marked on an idle side stream,
    to its completion: a mark behind its work on the current stream, or,
    where the driver has ``complete(out)`` (the call's own wait), a mark
    once that has returned. Both marks are on the device's clock."""
    span = (lambda: torch.profiler.record_function(trace.CALL_SPAN)) \
        if spans else contextlib.nullcontext
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    complete = getattr(drv, "complete", None)
    pending: deque = deque()
    latencies, kept = [], []

    def retire():
        j, out, issued, done, keep = pending.popleft()
        if complete is not None:
            out = complete(out)
            done = Marker(device)
        done.wait()
        latencies.append(done.ms_since(issued))
        if keep:
            kept.append((j, out))

    t0 = time.perf_counter()
    i = marked = 0   # calls issued, and of them marked to be kept

    def decide():
        elapsed = time.perf_counter() - t0
        go = i < calls if calls is not None else elapsed < seconds
        keep = (go and marked < len(keep_at) and elapsed >= keep_at[marked])
        return steer(go, keep) if steer is not None else (go, keep)

    go, keep = decide()
    while go:
        with span():
            issued = Marker(device, side)
            out = drv.call(i)
        pending.append((i, out, issued,
                        None if complete else Marker(device), keep))
        del out
        i += 1
        marked += keep
        # decided before the wait, so that rank 0's word travels while the
        # device works
        go, keep = decide()
        while len(pending) >= inflight:
            retire()
    while pending:
        retire()
    return {"calls": i, "window_s": time.perf_counter() - t0,
            "latencies_ms": latencies, "kept": kept}


def traced_loop(drv, inflight: int, device, calls: int, steer, path: Path):
    """``calls`` calls of the closed loop under `torch.profiler` (CPU and,
    on a card, CUDA activity); returns the trace's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_SPAN):
            closed_loop(drv, inflight, device, calls=calls, steer=steer,
                        spans=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        return trace.load(path)
    finally:
        path.unlink()


def cache_misses() -> int:
    import repro_torch.fft
    return repro_torch.fft.cache_info()["misses"]


def run_rank(cell: Cell, seed: int, seconds: float, traced: bool, device,
             rank: int = 0, world: int = 1, steer=None, t0: float | None = None,
             out_dir: Path = ROOT / "build" / "portbench") -> dict:
    """One rank's run: set-up, warm-up, the window, the trace, the check.
    Returns the rank's readings (`result` merges the ranks')."""
    t0 = time.perf_counter() if t0 is None else t0
    tr = cell.traffic
    ctx = Context(cell.config, tr, seed, device, rank, world)
    t_drv = time.perf_counter()
    drv = driver(cell, ctx)
    t_warm = time.perf_counter()
    closed_loop(drv, tr["inflight"], device, calls=tr["warmup_calls"],
                steer=steer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    # in the first 90 % of the window, so that a call is issued after each
    rng = random.Random(seed)
    keep_at = sorted(0.9 * seconds * rng.random()
                     for _ in range(tr["checked_calls"]))
    misses = cache_misses()
    # what set-up left behind is not scanned again by the collector inside
    # the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    print(f"setup_s {setup_s:.3f}: driver {t_warm - t_drv:.3f}, warm-up "
          f"{time.perf_counter() - t_warm:.3f}, before {t_drv - t0:.3f}",
          file=sys.stderr)
    win = closed_loop(drv, tr["inflight"], device, seconds=seconds,
                      keep_at=keep_at, steer=steer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    events = None
    if traced:
        events = traced_loop(drv, tr["inflight"], device, tr["traced_calls"],
                             steer, out_dir / f"trace_rank{rank}.json")
    misses = cache_misses() - misses
    kept = win.pop("kept")
    numbers = []
    while kept:
        i, out = kept.pop(0)
        numbers.append(drv.check(i, out))
        del out
    readings = {**win, "setup_s": setup_s, "peak_bytes": peak,
                "counters": {"plan_misses": misses}, "numbers": numbers,
                "in_bytes": drv.in_bytes,
                "bound_s": work.bound_s(drv.kind, cell.config, world)}
    if events is not None:
        lo, hi = trace.window(events)
        readings.update(events=events, busy_s=trace.busy_us(events) * 1e-6,
                        traced_window_s=(hi - lo) * 1e-6)
    return readings


GROUP_TIMEOUT_S = 120   # the longest a rank waits at a collective


def in_group(rank: int, world: int, port: int, device, job) -> list:
    """Join the process group at tcp://localhost:<port> (NCCL between cards,
    gloo on the CPU), run ``job(steer)`` and return every rank's result.
    ``steer`` carries rank 0's decisions (go on, keep this call) to the
    others over a gloo group, on the host and not the cards."""
    import torch.distributed as dist

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    t = time.perf_counter()
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank, device_id=device if cuda else None,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        ctl = dist.new_group(backend="gloo")
        print(f"group of {world} joined in {time.perf_counter() - t:.3f} s",
              file=sys.stderr)

        def steer(go, keep):
            flag = torch.tensor([int(go), int(keep)])
            dist.broadcast(flag, src=0, group=ctl)
            return bool(flag[0]), bool(flag[1])

        mine = job(steer)
        ranks = [None] * world
        dist.all_gather_object(ranks, mine, group=ctl)
        return ranks
    finally:
        dist.destroy_process_group()


def judge(cell: Cell, numbers: list[dict]) -> tuple[dict, int]:
    """The numbers compared, each at its worst over the checked calls,
    beside its limit; and how many checked calls exceeded a limit."""
    limits = cell.traffic["limits"]
    worst = {k: max(n[k] for n in numbers) for k in limits} if numbers else {}
    # a NaN meets no limit
    failed = sum(not all(n[k] <= lim for k, lim in limits.items())
                 for n in numbers)
    return ({k: {"value": v, "limit": limits[k]} for k, v in worst.items()},
            failed)


def result(cell: Cell, ranks: list[dict], traced: bool, device) -> dict:
    """The result line: rank 0's readings, the peak of the fullest chip and
    the busy time averaged over the chips."""
    run = dict(ranks[0])
    run["peak_bytes"] = max(r["peak_bytes"] for r in ranks)
    compared, failed = judge(cell, run["numbers"])
    names = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for name in names:
        value = reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.units[name]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run["peak_bytes"]}
    checked = len(run["numbers"]) == cell.traffic["checked_calls"]
    line = {"correct": checked and failed == 0,
            "attempted": run["calls"], "failed": failed, "metrics": metrics,
            "device": dev}
    if traced:
        dev["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        dev["window_s"] = run["traced_window_s"]
        line["breakdown"] = trace.breakdown(run["events"])
    line["compared"] = compared
    return line


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules (default: this process's) that no
    run may hold."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
