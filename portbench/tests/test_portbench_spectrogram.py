"""The spectrogram cell's own files: the work count by hand, its readers on
synthetic runs (nothing returned where they find nothing to read), the
reference against numpy, and a small copy of the cell run through the
harness on the CPU, sound (correct), with the timed path broken (not
correct) and with the control in the program's place (a limit failed). The
control at the cell's own size is a card test."""

import ast
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import (control, harness, spectrogram_reference,  # noqa: E402
                       spectrogram_work, trace)
from portbench.metrics import spectrogram_roofline  # noqa: E402

PB = ROOT / "portbench"
CELL = "spectrogram_1g.capture"
CONFIG = json.loads((PB / "configs" / "spectrogram_1g.json").read_text())
SEED = 2 ** 31 + 301
CPU = torch.device("cpu")
NEW = ["spectrogram_roofline", "spectral_issue_us",
       "torch_op_share_pct.spectrogram", "launches_per_call.spectrogram"]
PORT = "void (anonymous namespace)::rfft_kernel<false>(float2 const*, ...)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, ...>"
SPAN = "repro_torch.spectral.power_spectrogram"


def test_work_counts_by_hand():
    assert spectrogram_work.frames(CONFIG) == 524287 == \
        (2 ** 28 - 1024) // 512 + 1
    assert spectrogram_work.in_bytes(CONFIG) == 1_073_741_824
    assert spectrogram_work.out_bytes(CONFIG) == 1_075_836_924
    assert spectrogram_work.flops(CONFIG) == 13_421_747_200
    assert spectrogram_work.bound_s(CONFIG) * 1e3 == pytest.approx(0.64167,
                                                                    rel=1e-5)


@pytest.mark.parametrize("name", ["spectrogram_work.py",
                                  "spectrogram_reference.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    names = set()
    for node in ast.walk(ast.parse((PB / name).read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "json", "math", "pathlib", "torch",
                     "portbench"}
    assert "repro_torch" not in (PB / name).read_text()


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X",
            "args": {}}


def events():
    """Two calls of the cell: each K3 for 2 ms and PyTorch's kernels for
    1 ms (the window) and 1.2 ms (the power), the entry spans 300 and
    500 us."""
    out = [ev(trace.WINDOW_SPAN, "user_annotation", 0, 20000)]
    for t in (0, 10000):
        out += [ev(trace.CALL_SPAN, "user_annotation", t, 600),
                ev(SPAN, "user_annotation", t + 10, 300 if t == 0 else 500),
                ev(GLUE, "kernel", t + 1000, 1000),
                ev(PORT, "kernel", t + 2000, 2000),
                ev(GLUE, "kernel", t + 4000, 1200)]
    return out


def run(evs):
    return {"events": evs, "in_bytes": 2 ** 30, "counters": {},
            "bound_s": 1e-3}


def test_readers_against_the_hand_count():
    r = run(events())
    # 0.64167 ms of bound a call over 4.2 ms of device work a call
    assert harness.reader("spectrogram_roofline")(r) == pytest.approx(
        100 * 0.64167 / 4.2, rel=1e-4)
    assert harness.reader("spectral_issue_us")(r) == pytest.approx(400.0)
    assert harness.reader("torch_op_share_pct.spectrogram")(r) == \
        pytest.approx(100 * 2.2 / 4.2)
    assert harness.reader("launches_per_call.spectrogram")(r) == 3.0


@pytest.mark.parametrize("metric", NEW)
def test_a_reader_without_events_returns_nothing(metric):
    read = harness.reader(metric)
    assert read(run(None)) is None
    assert read(run([])) is None
    # host events alone, and none of the program's spectral spans: the
    # parent's program, say
    host = [e for e in events() if not trace.is_device(e)
            and e["name"] != SPAN]
    assert read(run(host)) is None


def test_roofline_reads_nothing_for_a_capture_no_configuration_has():
    assert spectrogram_roofline.read({**run(events()), "in_bytes": 12}) \
        is None


@pytest.mark.parametrize("frame,hop", [(64, 32), (1024, 512), (256, 128),
                                       (256, 256)])
def test_reference_agrees_with_numpy(frame, hop):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(5))
    n_frames = (4096 - frame) // hop + 1
    frames = np.stack([x.numpy()[hop * f: hop * f + frame].astype(np.float64)
                       for f in range(n_frames)])
    frames *= 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame) / frame)
    want = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    got = torch.cat([spectrogram_reference.power(x, frame, hop, f0, f1)
                     for f0, f1 in spectrogram_reference.blocks(n_frames, 5)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-9 * want.max())


# a small copy of the cell, as new files in a copied tree


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The cell's files copied with a configuration cut to 2^14 samples,
    its roofline reading the copy's configurations."""
    torch.set_num_threads(1)
    shutil.copytree(PB, tmp_path / "portbench")
    cfg = dict(CONFIG, samples=1 << 14, batch_shape=[(2 ** 14 - 1024)
                                                     // 512 + 1])
    (tmp_path / "portbench" / "configs" / "spectrogram_1g.json").write_text(
        json.dumps(cfg))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(spectrogram_roofline, "CONFIGS",
                        tmp_path / "portbench" / "configs")
    cell = harness.load_cell(tmp_path, CELL)
    cell.traffic.update(traced_calls=3)
    return cell


def test_the_cell_is_found_with_its_metrics(tiny):
    assert tiny.traffic["entry"] == "power_spectrogram"
    assert tiny.config["batch_shape"] == [31]
    assert set(NEW) <= set(tiny.per_layer)
    assert "transform_roofline" not in tiny.per_layer
    assert {"signal_GBps", "setup_s", "peak_GiB"} <= set(tiny.end_to_end)


def test_a_small_copy_of_the_cell_runs_correct(tiny):
    for traced in (False, True):
        r = harness.run_rank(tiny, SEED, 0.2, traced, CPU)
        line = harness.result(tiny, [r], traced, CPU)
        assert line["correct"], line["compared"]
        assert line["attempted"] > 0 and line["failed"] == 0
        assert r["in_bytes"] == 4 << 14
    # the CPU has no device operations: of the new metrics only the span's
    # reads there
    assert set(NEW) & set(line["metrics"]) == {"spectral_issue_us"}
    assert line["metrics"]["spectral_issue_us"]["value"] > 0
    # one entry span a traced call
    assert sum(trace.is_span(e, SPAN) for e in r["events"]) == \
        trace.calls(r["events"]) == 3


def _unchanged(drv, i, out):
    """The capture's first samples handed back in the power's place."""
    x = drv.pool[i % len(drv.pool)]
    return x[:out.numel()].reshape(out.shape).clone()


def _half(drv, i, out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _tile(drv, i, out):
    out = out.clone()
    out.view(-1)[256:512] = 0
    return out


def _nan(drv, i, out):
    out = out.clone()
    out.view(-1)[256] = float("nan")
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half, _tile, _nan],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tiny, fault, monkeypatch):
    real = harness.driver

    class Faulty:
        def __init__(self, drv):
            self.drv, self.in_bytes, self.kind = drv, drv.in_bytes, drv.kind

        def call(self, i):
            return fault(self.drv, i, self.drv.call(i))

        def check(self, i, out):
            return self.drv.check(i, out)

    monkeypatch.setattr(harness, "driver",
                        lambda c, ctx: Faulty(real(c, ctx)))
    r = harness.run_rank(tiny, SEED, 0.2, False, CPU)
    line = harness.result(tiny, [r], False, CPU)
    assert not line["correct"] and line["failed"] == 2


def test_the_control_fails_each_limit_and_the_program_meets_them(tiny):
    limits = tiny.traffic["limits"]
    for seed in (1, SEED):
        r = control.readings(tiny, seed, CPU)
        assert all(r["program"][k] <= lim for k, lim in limits.items()), r
        assert all(r["control"][k] > lim for k, lim in limits.items()), r


@pytest.mark.gpu
def test_control_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    cell = harness.load_cell(ROOT, CELL)
    limits = cell.traffic["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        r = control.readings(cell, seed, torch.device("cuda", 0))
        assert all(r["program"][k] <= lim for k, lim in limits.items()), r
        assert all(r["control"][k] > lim for k, lim in limits.items()), r
