"""The port's map-only job, stream executor and manifest journal
(`repro_torch.core.pipeline`), on the CPU: the cases of the JAX package's
tests/test_stream_pipeline.py and tests/test_pipeline_faults.py run
through the port's copies.

The contract under test: the overlapped pipeline is a drop-in for the
serial map loop — bitwise-identical merged output (including coalesced
batches and the remainder tail), the same retry / speculation /
crash-restart semantics, and exactly two cached plans for a coalesced run
(full batch + tail), each built once.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.fft as fft_api
from repro_torch.core.pipeline import (BlockStore, JobConfig, MapOnlyJob,
                                       SegmentFFTTransform, StagingPool)
from repro_torch.core.pipeline.maponly import Manifest, TaskState
from repro_torch.core.pipeline.records import (block_of_segments,
                                               segment_block_bytes,
                                               segments_of_block)

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

FFT_LEN = 128
SEG_PER_BLOCK = 16


def _signal_store(tmp_path, blocks=6, replication=1):
    rng = np.random.default_rng(7)
    sig = rng.standard_normal(
        (SEG_PER_BLOCK * blocks, FFT_LEN, 2)).astype(np.float32)
    store = BlockStore(tmp_path / "in",
                       block_bytes=segment_block_bytes(FFT_LEN, SEG_PER_BLOCK),
                       replication=replication)
    store.put_bytes(sig.tobytes())
    assert len(store.blocks) == blocks
    return store


def _bytes_store(tmp_path, blocks=6, replication=1):
    store = BlockStore(tmp_path / "in", block_bytes=64,
                       replication=replication)
    store.put_bytes(bytes(64 * blocks))
    return store


def _transform():
    return SegmentFFTTransform(FFT_LEN, impl="ref", device="cpu")


def _serial_map_fn(data, idx):
    re, im = segments_of_block(data, FFT_LEN)
    p = fft_api.plan(kind="c2c", n=FFT_LEN, batch_shape=re.shape[:-1],
                     impl="ref", device="cpu")
    yr, yi = p.execute(re, im)
    return block_of_segments(yr.numpy(), yi.numpy())


def _run_serial(store, tmp_path):
    job = MapOnlyJob(store, tmp_path / "out_serial", _serial_map_fn,
                     JobConfig(workers=2))
    job.run()
    job.merge(tmp_path / "serial.bin")
    return (tmp_path / "serial.bin").read_bytes()


# ---------------------------------------------------------------------------
# bitwise parity + coalescing


def test_stream_bitwise_identical_with_tail(tmp_path):
    """coalesce=4 over 6 blocks -> one full batch + one remainder tail."""
    store = _signal_store(tmp_path, blocks=6)
    expect = _run_serial(store, tmp_path)

    job = MapOnlyJob(store, tmp_path / "out_stream", transform=_transform(),
                     # speculation off: a scheduling-stall twin would add
                     # an extra batch and break the exact counts below
                     config=JobConfig(coalesce=4, inflight=2,
                                      speculation=False),
                     pipelined=True)
    stats = job.run()
    job.merge(tmp_path / "stream.bin")
    assert (tmp_path / "stream.bin").read_bytes() == expect
    assert stats.blocks_done == 6
    assert stats.batches == 2  # 4-block batch + 2-block tail
    assert stats.coalesced_blocks == 4
    assert all(v >= 0 for v in stats.stage_s.values())
    # journal fd released after the run (incl. the late-finisher drain)
    assert job.manifest._fh is None


def test_stream_mapfn_path_identical(tmp_path):
    """pipelined=True with a classic map_fn matches the serial output."""
    store = _signal_store(tmp_path, blocks=5)
    expect = _run_serial(store, tmp_path)
    # speculation off: a twin launched under a loaded host would add a
    # batch and break the exact count below
    job = MapOnlyJob(store, tmp_path / "out_mapfn", _serial_map_fn,
                     JobConfig(speculation=False), pipelined=True)
    stats = job.run()
    job.merge(tmp_path / "mapfn.bin")
    assert (tmp_path / "mapfn.bin").read_bytes() == expect
    assert stats.blocks_done == 5
    assert stats.batches == 5  # opaque bytes never coalesce


def test_pipelined_stage_clocks_cover_every_stage(tmp_path):
    """The pipelined stage_s has every stage, none negative; on the CPU
    (no device clock) compute is the launch's host time and d2h the
    realized copy's."""
    from repro_torch.core.pipeline.stream import STAGES
    store = _signal_store(tmp_path, blocks=6)
    job = MapOnlyJob(store, tmp_path / "out_clocks", transform=_transform(),
                     config=JobConfig(coalesce=2, inflight=2,
                                      speculation=False),
                     pipelined=True)
    stats = job.run()
    assert set(stats.stage_s) == set(STAGES)
    assert all(v >= 0 for v in stats.stage_s.values())
    assert stats.stage_s["compute"] > 0


class _ClockedTransform(SegmentFFTTransform):
    """Reports fixed device and copy clocks for every realized batch."""

    def clocks(self, handle):
        assert handle[0].copy_s is not None   # realize measured its copy
        return 0.5, 0.125


def test_pipelined_stages_take_the_transforms_clocks(tmp_path):
    """Where the transform measured a batch (the card: its device time and
    realize's copy), compute and d2h add those, not the host's clocks."""
    store = _signal_store(tmp_path, blocks=6)
    job = MapOnlyJob(store, tmp_path / "out_clocked",
                     transform=_ClockedTransform(FFT_LEN, impl="ref",
                                                 device="cpu"),
                     config=JobConfig(coalesce=2, inflight=2,
                                      speculation=False),
                     pipelined=True)
    stats = job.run()
    assert stats.batches == 3
    assert stats.stage_s["compute"] == 3 * 0.5
    assert stats.stage_s["d2h"] == 3 * 0.125


@pytest.mark.parametrize("blocks,plans", [(8, 1), (6, 2)])
def test_coalescing_uses_at_most_two_plans_built_once(tmp_path, blocks,
                                                      plans):
    """8 = 4+4 blocks -> ONE cached plan; 6 = 4+2 -> full + tail plans,
    each built exactly once however many batches reuse it (the
    cufftPlanMany amortization the stream dispatcher exists to feed)."""
    store = _signal_store(tmp_path, blocks=blocks)
    fft_api.clear_plan_cache()
    job = MapOnlyJob(store, tmp_path / "out", transform=_transform(),
                     config=JobConfig(coalesce=4, inflight=2,
                                      speculation=False),
                     pipelined=True)
    job.run()
    info = fft_api.cache_info()
    assert info["entries"] == plans, info
    for rows in (4, 2)[:plans]:
        p = fft_api.plan(kind="c2c", n=FFT_LEN,
                         batch_shape=(rows * SEG_PER_BLOCK,), impl="ref",
                         device="cpu")
        assert p.build_counts["forward"] == 1, (rows, p.build_counts)


# ---------------------------------------------------------------------------
# fault tolerance: the stream executor


class _FlakyTransform(SegmentFFTTransform):
    """Stage fault injection: ``stage`` ("decode", "encode", "launch" or
    "realize") of block ``fail_index`` (any block for launch/realize)
    raises ``times`` times."""

    def __init__(self, stage: str, times: int, fail_index=None):
        super().__init__(FFT_LEN, impl="ref", device="cpu")
        self.stage, self.times, self.fail_index = stage, times, fail_index
        self.fails = 0

    def _maybe_fail(self, stage, index=None):
        if stage == self.stage and self.fails < self.times and \
                index == self.fail_index:
            self.fails += 1
            raise RuntimeError(f"injected {stage} failure")

    def decode(self, data, index):
        self._maybe_fail("decode", index)
        return super().decode(data, index)

    def encode(self, host, row0, d):
        self._maybe_fail("encode", d.index)
        return super().encode(host, row0, d)

    def launch(self, batch):
        self._maybe_fail("launch")
        return super().launch(batch)

    def realize(self, handle):
        pending, batch = handle
        if self.stage == "realize" and self.fails < self.times:
            self.fails += 1

            class Boom:  # a device error surfacing at realization
                def realize(self):
                    raise RuntimeError("injected realize failure")

            # raises INSIDE the base realize: the finally there must
            # still return `batch` to the pool
            return super().realize((Boom(), batch))
        return super().realize(handle)


@pytest.mark.parametrize("stage,times,fail_index,cfg,retries", [
    # writeback: encode of one block fails once
    ("encode", 1, 3, dict(coalesce=4, inflight=2, max_retries=3), 1),
    # read: decode of one block fails twice
    ("decode", 2, 1, dict(coalesce=3, max_retries=5), 2),
    # device errors surface at realize (async dispatch); each transient
    # failure must return its staging set to the pool or the dispatcher
    # starves after capacity leaks (inflight+2 sets): 5 > capacity 3
    ("realize", 5, None, dict(coalesce=2, inflight=1, max_retries=9), None),
    # a launch that dies after gather must discard the gathered staging
    # (it has no realize to release it)
    ("launch", 5, None, dict(coalesce=2, inflight=1, max_retries=9), None),
])
def test_stage_failure_retries_to_identical_output(tmp_path, stage, times,
                                                   fail_index, cfg, retries):
    store = _signal_store(tmp_path, blocks=6 if retries else 8)
    expect = _run_serial(store, tmp_path)
    tr = _FlakyTransform(stage, times, fail_index)
    job = MapOnlyJob(store, tmp_path / "out", transform=tr,
                     config=JobConfig(speculation=False, **cfg),
                     pipelined=True)
    stats = job.run()
    job.merge(tmp_path / "m.bin")
    assert (tmp_path / "m.bin").read_bytes() == expect
    assert tr.fails == times
    assert stats.blocks_done == len(store.blocks)
    if retries is not None:
        assert stats.retries == retries


# ---------------------------------------------------------------------------
# fault tolerance shared by the serial job and the stream executor


def _identity(data, idx):
    return data


@pytest.mark.parametrize("pipelined", [False, True])
def test_poisoned_block_fails_job_after_budget(tmp_path, pipelined):
    if pipelined:
        store = _signal_store(tmp_path, blocks=4)
        tr = _FlakyTransform("decode", 10**9, fail_index=2)
        job = MapOnlyJob(store, tmp_path / "out", transform=tr,
                         config=JobConfig(coalesce=2, max_retries=3),
                         pipelined=True)
        victim = 2
    else:
        store = _bytes_store(tmp_path)

        def poison(data, idx):
            if idx == 1:
                raise RuntimeError("always fails")
            return data

        job = MapOnlyJob(store, tmp_path / "out", poison,
                         JobConfig(workers=2, max_retries=3))
        victim = 1
    with pytest.raises(RuntimeError, match=f"block {victim} failed 3 times"):
        job.run()
    # the other blocks still completed and are resumable
    assert job.manifest.tasks[victim].status == "FAILED"


def test_serial_retry_then_succeed(tmp_path):
    store = _bytes_store(tmp_path)
    fails = {"n": 0}

    def flaky(data, idx):
        if idx == 2 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("injected")
        return data

    job = MapOnlyJob(store, tmp_path / "out", flaky,
                     JobConfig(workers=2, max_retries=5))
    stats = job.run()
    assert stats.blocks_done == 6
    assert stats.retries == 2


@pytest.mark.parametrize("pipelined", [False, True])
def test_crash_resume_skips_done_blocks(tmp_path, pipelined):
    if pipelined:
        store = _signal_store(tmp_path, blocks=6)

        def make():
            return MapOnlyJob(store, tmp_path / "out",
                              transform=_transform(),
                              config=JobConfig(coalesce=4), pipelined=True)
    else:
        store = _bytes_store(tmp_path)

        def make():
            return MapOnlyJob(store, tmp_path / "out", _identity,
                              JobConfig(workers=2))
    make().run()
    # a restarted job re-reads the manifest and has nothing to do
    assert make().run().attempts == 0


def test_running_state_resets_to_pending_on_reopen(tmp_path):
    store = _bytes_store(tmp_path)
    job = MapOnlyJob(store, tmp_path / "out", _identity)
    job.manifest.update(3, status="RUNNING")  # simulate crash mid-task
    job2 = MapOnlyJob(store, tmp_path / "out", _identity,
                      JobConfig(workers=2))
    assert 3 in job2.manifest.pending()


@pytest.mark.parametrize("pipelined", [False, True])
def test_speculation_fires_on_a_straggler(tmp_path, pipelined):
    if pipelined:
        store = _signal_store(tmp_path, blocks=8)

        class SlowTail(SegmentFFTTransform):
            def encode(self, host, row0, d):
                time.sleep(0.8 if d.index == 7 else 0.005)
                return super().encode(host, row0, d)

        job = MapOnlyJob(store, tmp_path / "out",
                         transform=SlowTail(FFT_LEN, impl="ref",
                                            device="cpu"),
                         config=JobConfig(coalesce=1, inflight=4, writers=3,
                                          straggler_factor=2.0,
                                          min_completed_for_speculation=3),
                         pipelined=True)
    else:
        store = _bytes_store(tmp_path, blocks=8)

        def slow_tail(data, idx):
            time.sleep(0.6 if idx == 7 else 0.01)
            return data

        job = MapOnlyJob(store, tmp_path / "out", slow_tail,
                         JobConfig(workers=4, straggler_factor=3.0,
                                   min_completed_for_speculation=3))
    stats = job.run()
    assert stats.blocks_done == 8
    assert stats.speculative_launches >= 1


def test_mapfn_straggler_rescued_by_speculation(tmp_path):
    """A hung map_fn must not block the dispatcher: launch goes through
    the MapFnTransform compute pool, so a speculative twin completes the
    block and the job finishes while the primary is still stuck."""
    store = _signal_store(tmp_path, blocks=8)
    release = threading.Event()
    seen: list[int] = []

    def hang_once(data, idx):
        seen.append(idx)
        if idx == 5 and seen.count(5) == 1:
            release.wait(timeout=30)  # primary attempt hangs
        return data

    job = MapOnlyJob(store, tmp_path / "out", hang_once,
                     JobConfig(straggler_factor=2.0,
                               min_completed_for_speculation=3,
                               poll_interval_s=0.01),
                     pipelined=True)
    stats = job.run()
    release.set()  # unblock the abandoned primary thread
    assert stats.blocks_done == 8
    assert stats.speculative_launches >= 1
    job.merge(tmp_path / "m.bin")  # every block's output landed


@pytest.mark.parametrize("corrupt", [(0,), (0, 1)])
def test_replica_fallback_on_corruption(tmp_path, corrupt):
    store = _bytes_store(tmp_path, replication=2)
    good = store.read_block(0)
    for r in corrupt:
        store.corrupt_block(0, replica=r)
    if len(corrupt) == 2:
        with pytest.raises(IOError):
            store.read_block(0)
    else:
        assert store.read_block(0) == good  # checksum catches, replica serves


def test_idempotent_output_writes(tmp_path):
    """Two attempts writing the same block must be benign (speculation)."""
    store = _bytes_store(tmp_path)
    store.write_output_block(tmp_path / "out", 0, b"x" * 64)
    store.write_output_block(tmp_path / "out", 0, b"x" * 64)
    files = list((tmp_path / "out").glob("block_*.bin"))
    assert len(files) == 1


# ---------------------------------------------------------------------------
# staging pool back-pressure


def test_staging_pool_bounds_and_reuse():
    stop = threading.Event()
    pool = StagingPool(capacity=1, stop=stop)
    a = pool.acquire((4, 8))
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               and tuple(t.shape) == (4, 8) for t in a)
    got = []

    def second():
        got.append(pool.acquire((4, 8)))

    t = threading.Thread(target=second)
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()  # capacity 1 -> second acquire blocks
    pool.release((4, 8), a)
    t.join(timeout=2.0)
    assert not t.is_alive()
    assert got and got[0][0] is a[0]  # the SAME buffer was recycled


# ---------------------------------------------------------------------------
# manifest journal (append-only + compaction + crash replay)


def test_manifest_journal_is_o1_per_transition(tmp_path):
    m = Manifest(tmp_path / "j.json", num_blocks=64)
    base = (tmp_path / "j.json").stat().st_size
    m.update(0, status="RUNNING")
    one = (tmp_path / "j.json").stat().st_size - base
    for i in range(1, 33):
        m.update(i, status="RUNNING")
    grown = (tmp_path / "j.json").stat().st_size - base
    # append-only: each transition costs ~one line, NOT a table rewrite
    assert one < 128
    assert grown <= 33 * one + 64
    assert m.appends == 33


def test_manifest_crash_replay(tmp_path):
    path = tmp_path / "j.json"
    m = Manifest(path, num_blocks=4)
    m.update(0, status="DONE", finished_at=1.0)
    m.update(1, status="RUNNING", started_at=2.0)
    m.update(2, status="FAILED", attempts=3, error="boom")
    # crash: no compaction, journal is snapshot + 3 update lines
    assert len(path.read_text().splitlines()) == 4

    m2 = Manifest(path, num_blocks=4)
    assert m2.tasks[0].status == "DONE"
    assert m2.tasks[1].status == "PENDING"  # RUNNING at crash -> retry
    assert m2.tasks[2].status == "FAILED"
    assert m2.tasks[2].error == "boom"
    assert m2.tasks[3].status == "PENDING"
    # compaction on open: back to a single snapshot line
    assert len(path.read_text().splitlines()) == 1


def test_manifest_tolerates_torn_tail_write(tmp_path):
    path = tmp_path / "j.json"
    m = Manifest(path, num_blocks=3)
    m.update(0, status="DONE")
    with open(path, "a") as f:  # crash mid-append: half a JSON line
        f.write('{"type": "update", "index": 2, "fie')
    m2 = Manifest(path, num_blocks=3)
    assert m2.tasks[0].status == "DONE"  # durable prefix survives
    assert m2.tasks[2].status == "PENDING"  # torn record dropped


def test_manifest_reads_legacy_format(tmp_path):
    path = tmp_path / "j.json"
    legacy = {str(i): vars(TaskState(i)) for i in range(3)}
    legacy["1"]["status"] = "DONE"
    path.write_text(json.dumps(legacy))
    m = Manifest(path, num_blocks=3)
    assert m.tasks[1].status == "DONE"
    assert m.tasks[0].status == "PENDING"


def test_manifest_crash_mid_compact_replays_same_states(
        tmp_path, monkeypatch):
    """A crash inside _compact (power cut between tmp-write and rename)
    must leave the journal byte-identical, so a reopen replays the SAME
    task states — and must not leak the tmp snapshot file."""
    import os as _os

    path = tmp_path / "j.json"
    m = Manifest(path, num_blocks=4)
    m.update(0, status="DONE", finished_at=1.0)
    m.update(1, status="RUNNING", started_at=2.0)
    m.update(3, status="FAILED", attempts=3, error="boom")
    m.close()
    with open(path, "a") as f:  # plus a torn tail from the same crash
        f.write('{"type": "update", "index": 2, "fie')
    journal_before = path.read_bytes()

    real_replace = _os.replace

    def crash_replace(src, dst):
        raise OSError("simulated crash mid-compact")

    monkeypatch.setattr("repro_torch.core.pipeline.maponly.os.replace",
                        crash_replace)
    with pytest.raises(OSError, match="mid-compact"):
        Manifest(path, num_blocks=4)
    monkeypatch.setattr("repro_torch.core.pipeline.maponly.os.replace",
                        real_replace)

    # the journal is untouched and no .mtmp_ snapshot leaked
    assert path.read_bytes() == journal_before
    assert not list(tmp_path.glob(".mtmp_*"))

    m2 = Manifest(path, num_blocks=4)
    assert m2.tasks[0].status == "DONE"
    assert m2.tasks[1].status == "PENDING"  # RUNNING at crash -> retry
    assert m2.tasks[2].status == "PENDING"  # torn record dropped
    assert m2.tasks[3].status == "FAILED"
    assert m2.tasks[3].error == "boom"
    # and the successful reopen compacted back to one snapshot line
    assert len(path.read_text().splitlines()) == 1
    m2.update(2, status="DONE")  # journal usable after recovery
    assert Manifest(path, num_blocks=4).tasks[2].status == "DONE"
