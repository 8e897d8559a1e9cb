"""The port's spans (`repro_torch.spans`) on the CPU: a shared no-op while
no profiler records, and under `torch.profiler` each entry point's span
with its passes' spans inside it, read from the Chrome trace as the
benchmark reads them (``cat`` "user_annotation")."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.fft as tfft
from repro_torch import spans
from repro_torch.fft.planner import AsyncResult

# the suite runs one process per core (xdist): keep torch to one thread
torch.set_num_threads(1)

FFT = "repro_torch.fft."


def _planes(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g), torch.randn(shape, generator=g))


def _traced(fn, tmp_path):
    """Run ``fn`` under a CPU profiler; the trace's user spans, in order of
    their start, as (name, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"),
                  key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_is_one_shared_no_op(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    assert spans.span("a") is spans.span("b")
    with spans.span("a") as entered:
        assert entered is None
    p = tfft.plan(kind="r2c", shape=(8, 16), batch_shape=(2,), device="cpu")
    sr, si = p.execute_real(torch.randn(2, 8, 16))
    p.execute_inverse(sr, si)
    assert made == []


# (entry, plan arguments, the pass spans its call must hold)
ENTRIES = [
    ("execute", dict(kind="c2c", shape=(8, 16)), {"rows", "axis_pass"}),
    ("execute_real", dict(kind="r2c", shape=(8, 16)),
     {"rows", "axis_pass", "untangle"}),
    ("execute_real", dict(kind="r2c", n=16384), {"rows", "untangle"}),
    ("execute_inverse", dict(kind="c2c", shape=(8, 16)),
     {"rows", "axis_pass"}),
    ("execute_inverse", dict(kind="r2c", shape=(8, 16)),
     {"rows", "axis_pass"}),
    ("execute_async", dict(kind="c2c", n=1024), {"rows"}),
]


@pytest.mark.parametrize("entry,kw,passes", ENTRIES,
                         ids=[f"{e}-{kw['kind']}-{i}"
                              for i, (e, kw, _) in enumerate(ENTRIES)])
def test_each_entry_records_its_span_with_the_passes_inside(
        tmp_path, entry, kw, passes):
    p = tfft.plan(batch_shape=(2,), device="cpu", **kw)
    if entry == "execute_inverse":
        shape = p.output_shape
        args = _planes(shape)
    elif kw["kind"] == "r2c":
        args = _planes(p.operand_shape)[:1]
    else:
        args = _planes(p.operand_shape)
    got = _traced(lambda: getattr(p, entry)(*args), tmp_path)
    outer = [s for s in got if s[0] == FFT + entry]
    assert len(outer) == 1, got
    inner = [s for s in got if s is not outer[0]]
    assert {s[0] for s in inner} == {FFT + name for name in passes}
    assert all(_inside(s, outer[0]) for s in inner), got


def test_realize_records_its_copy_inside_it(tmp_path):
    p = tfft.plan(kind="c2c", n=64, batch_shape=(2,), device="cpu")
    x = _planes((2, 64))
    pending = p.execute_async(*x)
    got = _traced(pending.realize, tmp_path)
    assert [s[0] for s in got] == [FFT + "realize", FFT + "realize.copy"]
    assert _inside(got[1], got[0])
    assert pending.copy_s >= 0 and pending.device_ms is None


class _Event:
    """Stands in for a CUDA event: `synchronize` is the wait."""

    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True


def test_realize_waits_then_copies(tmp_path):
    yr, yi = _planes((2, 64))
    pending = AsyncResult(yr, yi, _Event())
    out = []
    got = _traced(lambda: out.extend(pending.realize()), tmp_path)
    assert [s[0] for s in got] == [FFT + "realize", FFT + "realize.wait",
                                   FFT + "realize.copy"]
    wait, copy = got[1], got[2]
    assert _inside(wait, got[0]) and _inside(copy, got[0])
    assert wait[2] <= copy[1]
    assert pending.event.waited
    np.testing.assert_array_equal(out[0], yr.numpy())
    np.testing.assert_array_equal(out[1], yi.numpy())
