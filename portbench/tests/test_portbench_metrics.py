"""Each metric reader on synthetic runs and profiler events: the union of
intervals, the shares, NCCL's and PyTorch's kernels by name, and a reader
that finds nothing returning nothing."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, trace  # noqa: E402

PORT = "void (anonymous namespace)::rows_kernel<false>(float const*, ...)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, ...>"
NCCL = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"


def ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X",
            "args": args}


def events():
    """A window of 100 us with two calls: the port's kernel 10-40 and
    30-50 (overlapping), PyTorch's 60-70, NCCL 70-80, a device copy 85-90,
    a host transfer 92-94; idle 0-10, 50-60, 80-85, 90-92, 94-100."""
    return [
        ev(trace.WINDOW_SPAN, "user_annotation", 0, 100),
        ev(trace.WINDOW_SPAN, "gpu_user_annotation", 0, 100),
        ev(trace.CALL_SPAN, "user_annotation", 1, 5),
        ev(trace.CALL_SPAN, "user_annotation", 45, 5),
        ev(trace.CALL_SPAN, "gpu_user_annotation", 10, 40),
        ev("cudaEventSynchronize", "cuda_runtime", 50, 12),
        ev(PORT, "kernel", 10, 30),
        ev(PORT, "kernel", 30, 20),
        ev(GLUE, "kernel", 60, 10),
        ev(NCCL, "kernel", 70, 10),
        ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 85, 5),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 92, 2,
           bytes=4000),
    ]


def run(**kw):
    return {"events": events(), "counters": {"plan_misses": 0},
            "bound_s": 20e-6, **kw}


def read(metric, r):
    return harness.reader(metric)(r)


def test_union_of_intervals():
    assert trace.merged([(5, 7), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 7)]
    assert trace.busy_us(events()) == 40 + 10 + 10 + 5 + 2
    assert trace.window(events()) == (0, 100)
    assert trace.calls(events()) == 2


def test_kernel_names():
    port, glue, nccl = (ev(n, "kernel", 0, 1) for n in (PORT, GLUE, NCCL))
    assert trace.is_port_kernel(port) and not trace.is_torch_glue(port)
    assert trace.is_torch_glue(glue) and not trace.is_nccl(glue)
    assert trace.is_nccl(nccl) and not trace.is_torch_glue(nccl)
    assert trace.is_torch_glue(ev("Memcpy DtoD", "gpu_memcpy", 0, 1))
    assert not trace.is_torch_glue(ev("Memcpy HtoD", "gpu_memcpy", 0, 1))


def test_layer_readers():
    r = run()
    assert read("launches_per_call", r) == 4 / 2
    device_us = 30 + 20 + 10 + 10 + 5 + 2
    assert read("torch_op_share_pct", r) == pytest.approx(
        100 * (10 + 5) / device_us)
    assert read("exchange_share_pct", r) == pytest.approx(100 * 10 / 67)
    assert read("device_idle_pct", r) == pytest.approx(33.0)
    # the bound of two calls over the port's kernels, PyTorch's and the
    # device copy: 40 us over 65 us
    assert read("transform_roofline", r) == pytest.approx(100 * 40 / 65)
    assert read("plan_misses", r) == 0.0
    # 4000 bytes host to device in 2 us
    assert read("h2d_GBps", r) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", ["launches_per_call", "torch_op_share_pct",
                                    "transform_roofline", "exchange_share_pct",
                                    "device_idle_pct", "h2d_GBps"])
def test_a_reader_that_finds_nothing_returns_nothing(metric):
    assert read(metric, run(events=None)) is None
    host_only = [e for e in events() if not trace.is_device(e)]
    assert read(metric, run(events=host_only)) is None


def test_exchange_share_needs_nccl():
    no_nccl = [e for e in events() if not trace.is_nccl(e)]
    assert read("exchange_share_pct", run(events=no_nccl)) is None


def test_breakdown_names_what_the_host_did_in_each_gap():
    b = trace.breakdown(events())
    ops = dict(b["device_ops"])
    assert ops[PORT[:trace.NAME_CHARS]] == pytest.approx(50e-6)
    gaps = dict(b["idle_gaps"])
    # 50-60 lies inside the event synchronize; 0-10 inside the first call
    assert gaps["cudaEventSynchronize"] == pytest.approx(10e-6)
    assert gaps[trace.CALL_SPAN] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(33e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_end_to_end_readers():
    r = {"calls": 400, "in_bytes": 2 ** 28, "window_s": 10.0,
         "latencies_ms": [float(i) for i in range(1, 101)],
         "peak_bytes": 3 * 2 ** 30, "setup_s": 8.5}
    assert read("signal_GBps", r) == pytest.approx(400 * 2 ** 28 / 1e10)
    assert read("call_p95_ms", r) == 95.0
    assert read("peak_GiB", r) == 3.0
    assert read("setup_s", r) == 8.5
    assert read("call_p95_ms", {**r, "latencies_ms": []}) is None


def test_a_named_part_of_a_metric_is_read_by_its_reader():
    assert harness.reader("signal_GBps.host") is harness.reader("signal_GBps")
    assert harness.reader("device_idle_pct.host") is \
        harness.reader("device_idle_pct")
