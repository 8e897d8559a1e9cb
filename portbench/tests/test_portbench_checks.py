"""The comparison that decides ``correct``, at sizes a test run holds, on
the CPU: the harness's run with the look for a chip skipped, sound and
with the timed path broken underneath (each fault must read false), and
the control, the reference in TF32 in the program's place, which must
fail a limit while the program meets them all. Beside the cells of
BENCHMARK.json, the entries that no cell drives yet (`execute_real`, and
`distributed` as four gloo ranks) are held to the same, so that a later
cell on them is data files alone."""

import json
import multiprocessing
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import control, harness, ranks  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 101
# (id, cell, entry in its place or None, shape, batch_shape): the cells'
# shapes cut to what a test holds, and 2-D transforms through the entries
SMALL = [("paper_c2c1024.device", "paper_c2c1024.device", None, [1024], [16]),
         ("paper_c2c1024.host", "paper_c2c1024.host", None, [1024], [16]),
         ("execute_2d", "paper_c2c1024.device", "execute", [32, 64], [2]),
         ("execute_real_2d", "paper_c2c1024.device", "execute_real", [32, 64],
          [2])]
IDS = [s[0] for s in SMALL]
TILE = 256   # values an altered answer loses


def small(_, name, entry, shape, batch):
    cell = harness.load_cell(ROOT, name)
    cell.config.update(shape=shape, batch_shape=batch)
    cell.traffic.update(sampled_bins=64, traced_calls=3)
    if entry is not None:
        cell.traffic["entry"] = entry
    return cell


def unchanged(drv, i, out):
    """The call hands back its operand (a real one as its first bins)."""
    x = drv.pool[i % len(drv.pool)]
    if len(x) == 1:
        m = out[0].shape[-1]
        return x[0][..., :m].clone(), torch.zeros_like(out[1])
    return tuple(t.clone() for t in x)


def not_a_number(drv, i, out):
    """One answer comes out as NaN."""
    yr, yi = (t.clone() for t in out)
    yr.view(-1)[TILE] = float("nan")
    return yr, yi


def half_batch(drv, i, out):
    """The second half of the batch left out."""
    yr, yi = (t.clone() for t in out)
    h = yr.shape[0] // 2
    yr[h:], yi[h:] = 0, 0
    return yr, yi


def altered(drv, i, out):
    """One tile of answers lost where it is produced (on rank 1 alone where
    the signal is split)."""
    if getattr(drv, "rank", 1) != 1:
        return out
    yr, yi = (t.clone() for t in out)
    yr.view(-1)[TILE:2 * TILE] = 0
    return yr, yi


class Faulty:
    def __init__(self, drv, fault):
        self.drv, self.fault = drv, fault
        self.in_bytes = drv.in_bytes
        self.rank = getattr(drv, "rank", 1)

    def __getattr__(self, name):
        return getattr(self.drv, name)

    def call(self, i):
        out = self.drv.call(i)
        if hasattr(out, "realize"):
            # a launched transform: its planes altered where they are made
            out.yr, out.yi = self.fault(self.drv, i, (out.yr, out.yi))
            return out
        return self.fault(self.drv, i, out)


def run(cell, fault=None, traced=False, monkeypatch=None):
    if fault is not None:
        real = harness.driver
        monkeypatch.setattr(harness, "driver",
                            lambda c, ctx: Faulty(real(c, ctx), fault))
    r = harness.run_rank(cell, SEED, 0.2, traced, CPU)
    return harness.result(cell, [r], traced, CPU)


@pytest.mark.parametrize("case", SMALL, ids=IDS)
def test_sound_runs_are_correct(case):
    for traced in (False, True):
        line = run(small(*case), traced=traced)
        assert line["correct"], line["compared"]
        assert list(line)[-1] == "compared"
        assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered,
                                   not_a_number],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("case", SMALL, ids=IDS)
def test_a_broken_timed_path_is_not_correct(case, fault, monkeypatch):
    line = run(small(*case), fault, monkeypatch=monkeypatch)
    assert not line["correct"]
    assert line["failed"] == 2   # both checked calls


@pytest.mark.parametrize("case", SMALL, ids=IDS)
def test_the_control_fails_a_limit_and_the_program_meets_them(case):
    cell = small(*case)
    limits = cell.traffic["limits"]
    for seed in (1, SEED):
        r = control.readings(cell, seed, CPU)
        assert all(r["program"][k] <= lim for k, lim in limits.items()), r
        assert any(r["control"][k] > lim for k, lim in limits.items()), r


# one signal split over four ranks (`entries/distributed.py`): four gloo
# ranks, every case in one group


def distributed(n):
    cell = harness.load_cell(ROOT, "paper_c2c1024.device")
    cell.config.update(shape=[n], batch_shape=[])
    cell.chips = 4
    cell.traffic.update(
        entry="distributed", inflight=1, pool=1, warmup_calls=2,
        checked_calls=1, traced_calls=3, sampled_bins=64, probes=4,
        limits={"rel_rms_err": 1e-5, "rel_max_err": 5e-5, "probe_err": 2e-5})
    return cell

def no_exchange(on: bool):
    """The exchanges between ranks left out: each keeps what it would send
    (``on``), or put back."""
    from repro_torch.core.fft import distributed
    ex = distributed._Exchange
    if on:
        no_exchange.saved = ex.all_to_all, ex.start
        ex.all_to_all = lambda self, send: send.clone()
        ex.start = lambda self, take, place: [[], []]
    else:
        ex.all_to_all, ex.start = no_exchange.saved


def rank_job(rank, port, queue):
    torch.set_num_threads(1)
    cell = distributed(1 << 14)

    def job(steer):
        lines = {}
        real = harness.driver
        for name, fault in [("sound", None), ("unchanged", unchanged),
                            ("altered", altered), ("no_exchange", None)]:
            harness.driver = (real if fault is None else
                              lambda c, ctx, f=fault: Faulty(real(c, ctx), f))
            if name == "no_exchange":
                no_exchange(True)
            lines[name] = harness.run_rank(cell, SEED, 0.2, name == "sound",
                                           CPU, rank, 4, steer)
            if name == "no_exchange":
                no_exchange(False)
        harness.driver = real
        lines["control"] = control.readings(cell, SEED, CPU, rank, 4)
        return lines

    ranks = harness.in_group(rank, 4, port, CPU, job)
    if rank == 0:
        out = {k: harness.result(cell, [r[k] for r in ranks], k == "sound",
                                 CPU) for k in ("sound", "unchanged",
                                                "altered", "no_exchange")}
        out["control"] = ranks[0]["control"]
        out["limits"] = cell.traffic["limits"]
        queue.put(json.dumps(out))


def test_four_rank_cell_checks():
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = ranks.free_port()
    procs = [ctx.Process(target=rank_job, args=(r, port, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        out = json.loads(queue.get(timeout=240))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert out["sound"]["correct"], out["sound"]["compared"]
    for fault in ("unchanged", "altered", "no_exchange"):
        assert not out[fault]["correct"], (fault, out[fault]["compared"])
    limits, ctl = out["limits"], out["control"]
    assert all(ctl["program"][k] <= lim for k, lim in limits.items()), ctl
    assert any(ctl["control"][k] > lim for k, lim in limits.items()), ctl
