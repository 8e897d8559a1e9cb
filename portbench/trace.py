"""Reading a `torch.profiler` trace: device operations, host spans, the
device's busy time, and the breakdown a result line carries.

The profiler's Chrome trace is the input (`load`), so the reading does not
depend on the profiler's Python objects. An event is a dict with ``name``,
``cat``, ``ts`` and ``dur`` (microseconds) and ``args``. Device operations
are the categories in `DEVICE_CATS`; host events are the rest.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the benchmark's own spans (`record_function` in harness.py)
WINDOW_SPAN = "portbench.traced_window"
CALL_SPAN = "portbench.call"
# the port's kernels, by the names of their `__global__` functions in
# src/repro_torch/csrc/*.cu
PORT_KERNELS = ("rows_kernel", "cols_kernel", "rfft_kernel",
                "stockham_kernel")
NAME_CHARS = 160   # a breakdown entry's name is cut to this length


def load(path: Path) -> list[dict]:
    """Every complete event ("ph": "X") of a Chrome trace file."""
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def is_device(e: dict) -> bool:
    return e.get("cat") in DEVICE_CATS


def is_kernel(e: dict) -> bool:
    return e.get("cat") == "kernel"


def is_nccl(e: dict) -> bool:
    return is_kernel(e) and "nccl" in e["name"].lower()


def is_port_kernel(e: dict) -> bool:
    return is_kernel(e) and any(k in e["name"] for k in PORT_KERNELS)


def is_torch_glue(e: dict) -> bool:
    """Device work that PyTorch itself issues around the port's kernels:
    its kernels (elementwise, copies, reductions) and device-to-device
    copies and fills; not NCCL, not host transfers."""
    if is_kernel(e):
        return not (is_port_kernel(e) or is_nccl(e))
    if e.get("cat") == "gpu_memcpy":
        return "DtoD" in e["name"]
    return e.get("cat") == "gpu_memset"


def is_span(e: dict, name: str) -> bool:
    """A host span of the benchmark's (the profiler also copies each one
    onto the device's timeline, as category "gpu_user_annotation")."""
    return e.get("cat") == "user_annotation" and e["name"] == name


def window(events: list[dict]) -> tuple[float, float]:
    """(start, end) in microseconds of the traced window: the benchmark's
    window span, or every event's extent where there is none."""
    spans = [e for e in events if is_span(e, WINDOW_SPAN)]
    if spans:
        s = spans[0]
        return float(s["ts"]), float(s["ts"]) + float(s["dur"])
    return (min(float(e["ts"]) for e in events),
            max(float(e["ts"]) + float(e["dur"]) for e in events))


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clipped(events, lo: float, hi: float) -> list[tuple[float, float]]:
    spans = ((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events)
    return [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]


def busy_us(events: list[dict]) -> float:
    """Microseconds of the traced window in which some device operation
    ran: the union of their intervals, clipped to the window."""
    lo, hi = window(events)
    return sum(e - s for s, e in merged(clipped(
        [e for e in events if is_device(e)], lo, hi)))


def calls(events: list[dict]) -> int:
    """Calls the traced window issued (the benchmark's call spans)."""
    return sum(1 for e in events if is_span(e, CALL_SPAN))


def breakdown(events: list[dict], top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time inside the window by what the host was doing meanwhile (the
    shortest host event covering the middle of each gap), each as
    [[name, seconds], ...], longest first."""
    lo, hi = window(events)
    dev = [e for e in events if is_device(e)]
    ops: dict[str, float] = defaultdict(float)
    for e in dev:
        ops[e["name"][:NAME_CHARS]] += float(e["dur"]) * 1e-6
    host = [e for e in events if not is_device(e)
            and e.get("cat") != "gpu_user_annotation"
            and not is_span(e, WINDOW_SPAN)]
    gaps: dict[str, float] = defaultdict(float)
    edge = lo
    for s, e in merged(clipped(dev, lo, hi)) + [(hi, hi)]:
        if s > edge:
            mid = (edge + s) / 2
            cover = [h for h in host
                     if float(h["ts"]) <= mid <= float(h["ts"]) + float(h["dur"])]
            name = (min(cover, key=lambda h: float(h["dur"]))["name"]
                    if cover else "(no host event)")
            gaps[name[:NAME_CHARS]] += (s - edge) * 1e-6
        edge = max(edge, e)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
