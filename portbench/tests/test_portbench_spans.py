"""The readers of the program's spans (`portbench/program_spans.py`) on
synthetic profiler events: each a mean over its own spans, the device
copies of the spans and the benchmark's call spans left out, and nothing
returned where the program records no span. Then a traced run of each
cell through the harness on the CPU, whose line carries them."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness, trace  # noqa: E402

FFT = "repro_torch.fft."


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X",
            "args": {}}


def events():
    """Three calls of 100 us: the benchmark's call spans; entry spans of
    20, 30 and 40 us (one of them `execute_async`), each with a pass span
    inside; two realizes, waits of 5 and 15 us, copies of 60 and 80 us;
    the device's copies of the spans, which are not host time."""
    return [
        ev(trace.WINDOW_SPAN, "user_annotation", 0, 300),
        *(ev(trace.CALL_SPAN, "user_annotation", t, 100)
          for t in (0, 100, 200)),
        ev(FFT + "execute", "user_annotation", 1, 20),
        ev(FFT + "execute", "user_annotation", 101, 30),
        ev(FFT + "execute_async", "user_annotation", 201, 40),
        ev(FFT + "execute", "gpu_user_annotation", 5, 500),
        *(ev(FFT + "rows", "user_annotation", t + 2, 10)
          for t in (0, 100, 200)),
        ev(FFT + "realize", "user_annotation", 30, 70),
        ev(FFT + "realize.wait", "user_annotation", 31, 5),
        ev(FFT + "realize.copy", "user_annotation", 37, 60),
        ev(FFT + "realize", "user_annotation", 140, 98),
        ev(FFT + "realize.wait", "user_annotation", 141, 15),
        ev(FFT + "realize.copy", "user_annotation", 157, 80),
        ev(FFT + "realize.copy", "gpu_user_annotation", 157, 900),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 40, 55),
    ]


def read(metric, evs):
    return harness.reader(metric)({"events": evs})


def test_each_reader_is_a_mean_over_its_own_spans():
    evs = events()
    assert read("issue_us", evs) == pytest.approx((20 + 30 + 40) / 3)
    assert read("issue_us.host", evs) == read("issue_us", evs)
    assert read("realize_wait_ms", evs) == pytest.approx((5 + 15) / 2e3)
    assert read("realize_copy_ms", evs) == pytest.approx((60 + 80) / 2e3)


METRICS = ["issue_us", "issue_us.host", "realize_wait_ms",
           "realize_copy_ms"]


@pytest.mark.parametrize("metric", METRICS)
def test_a_span_reader_without_spans_returns_nothing(metric):
    assert read(metric, None) is None
    assert read(metric, []) is None
    # a program that records no span: the parent of the spans, say
    theirs = [e for e in events() if not e["name"].startswith(FFT)]
    assert read(metric, theirs) is None


# (cell, the span metrics its traced line carries on the CPU: no wait there,
# `realize` has no event to wait for)
CELLS = [("paper_c2c1024.device", {"issue_us"}),
         ("paper_c2c1024.host", {"issue_us.host", "realize_copy_ms"})]


@pytest.mark.parametrize("name,found", CELLS, ids=[c[0] for c in CELLS])
def test_a_traced_line_carries_the_span_metrics(name, found):
    torch.set_num_threads(1)
    cell = harness.load_cell(ROOT, name)
    cell.config.update(shape=[1024], batch_shape=[16])
    cell.traffic.update(traced_calls=3)
    run = harness.run_rank(cell, 2 ** 31 + 5, 0.2, True, torch.device("cpu"))
    line = harness.result(cell, [run], True, torch.device("cpu"))
    spans = set(METRICS) & set(cell.per_layer)
    assert spans & set(line["metrics"]) == found
    for m in found:
        assert line["metrics"][m]["value"] > 0
    # one entry span a traced call, and on the host path one realize
    calls = trace.calls(run["events"])
    entries = [e for e in run["events"]
               if e.get("cat") == "user_annotation"
               and e["name"].startswith(FFT + "execute")]
    assert len(entries) == calls == 3
    if name.endswith(".host"):
        assert sum(trace.is_span(e, FFT + "realize.copy")
                   for e in run["events"]) == calls
