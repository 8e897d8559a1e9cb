"""The port's ABFT silent-corruption defense, corrupt fault rules and
BlockStore integrity errors (`repro_torch.core.resilience`,
`repro_torch.core.pipeline.blockstore`), on the CPU: the cases of the JAX
package's tests/test_verify.py and tests/test_blockstore_integrity.py run
through the port's copies (the serve cases wait for the service's port).

Contract under test: the ``corrupt`` fault kind perturbs values at
post-CRC checkpoints where every byte-integrity layer has already signed
off; the verification modes ("parseval" per-member energy, "abft"
checksum row per launch) are the only defense, detections raise
`SilentCorruption` (an IOError, hence retryable by the one RetryPolicy),
and the quarantined unit recomputes to the bitwise-clean answer. Every
block-granular store failure names its block.
"""

import os
import threading

import numpy as np
import pytest
import torch

import repro_torch.fft as fft_api
from repro_torch.core.pipeline import (BlockIntegrityError, BlockStore,
                                       JobConfig, MapOnlyJob,
                                       SegmentFFTTransform)
from repro_torch.core.pipeline.records import segment_block_bytes
from repro_torch.core.resilience import (FaultInjector, FaultPlan,
                                         RetryPolicy, clear_events, events)
from repro_torch.core.resilience import verify as abft
from repro_torch.core.resilience.faults import (KINDS, FaultRule,
                                                corrupt_salt, perturb_array)
from repro_torch.launch.fft_job import parseval_verify_fn, serial_map_fn

pytestmark = pytest.mark.verify

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

FFT_LEN = 128
SEG_PER_BLOCK = 16
BB = 512  # small store blocks for the integrity cases


def _execute(rows, *planes):
    p = fft_api.plan(kind="c2c", n=FFT_LEN, batch_shape=(rows,), impl="ref",
                     device="cpu")
    return [a.numpy() for a in p.execute(*planes)]


# ---------------------------------------------------------------------------
# invariant checkers


def test_check_mode_accepts_known_rejects_unknown():
    for m in abft.VERIFY_MODES:
        assert abft.check_mode(m) == m
    with pytest.raises(ValueError, match="verify mode"):
        abft.check_mode("checksum")


def test_tolerances_derive_from_eps_and_depth():
    # deeper transforms accumulate more rounding -> wider tolerance
    assert abft.parseval_rtol(1 << 20) > abft.parseval_rtol(1 << 4)
    # f64 eps is ~2^-29 of f32's
    assert abft.parseval_rtol(1 << 10, "f64") < abft.parseval_rtol(1 << 10)
    # the batch reduction widens the checksum tolerance with sqrt(rows)
    assert abft.abft_rtol(FFT_LEN, 64) > abft.abft_rtol(FFT_LEN, 4) \
        > abft.parseval_rtol(FFT_LEN)


def test_energy_squares_native_accumulates_float64(rng):
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(500).astype(np.float32)
    # exact contract: squares in the operand dtype (so re-summing the
    # same values is reproducible), accumulation in float64
    want = float(np.sum(np.square(a), dtype=np.float64)
                 + np.sum(np.square(b), dtype=np.float64))
    assert abft.energy(a, b) == want
    # and still within f32 eps of the all-float64 reference
    ref = float(np.sum(np.square(a, dtype=np.float64))
                + np.sum(np.square(b, dtype=np.float64)))
    assert abft.energy(a, b) == pytest.approx(ref, rel=1e-6)


def test_energy_onesided_matches_full_spectrum(rng):
    x = rng.standard_normal(FFT_LEN)
    full = abft.energy(np.fft.fft(x).real, np.fft.fft(x).imag)
    half = np.fft.rfft(x)
    assert abft.energy_onesided(half.real, half.imag, FFT_LEN) == \
        pytest.approx(full, rel=1e-9)


def _planar_batch(rng, rows):
    return (rng.standard_normal((rows, FFT_LEN)).astype(np.float32),
            rng.standard_normal((rows, FFT_LEN)).astype(np.float32))


def test_parseval_passes_honest_fft_catches_perturbation(rng):
    xr, xi = _planar_batch(rng, 4)
    yr, yi = _execute(4, xr, xi)
    e_in = abft.energy(xr, xi)
    abft.check_parseval(e_in, abft.energy(yr, yi), FFT_LEN,
                        site="stream.realize")  # honest: no raise
    bad = perturb_array(yr.copy(), 0.5, corrupt_salt("stream.realize", 0))
    clear_events()
    with pytest.raises(abft.SilentCorruption) as exc:
        abft.check_parseval(e_in, abft.energy(bad, yi), FFT_LEN,
                            site="stream.realize", index=3)
    assert exc.value.site == "stream.realize" and exc.value.index == 3
    evs = events("verify_failed")
    assert len(evs) == 1 and evs[0]["invariant"] == "parseval"


@pytest.mark.parametrize("row", [2, 4])  # a member row, the checksum row
def test_checksum_row_passes_linearity_catches_any_row(rng, row):
    rows = 4
    xr, xi = _planar_batch(rng, rows)
    w = abft.checksum_weights(rows, seed=rows)
    ops = abft.add_checksum_row([xr, xi], w)
    host = _execute(rows + 1, *ops)
    abft.check_checksum(host, w, FFT_LEN, site="stream.realize")  # honest
    bad = [host[0].copy(), host[1]]
    bad[0][row] = perturb_array(bad[0][row].copy(), 0.5,
                                corrupt_salt("stream.realize", row))
    with pytest.raises(abft.SilentCorruption):
        abft.check_checksum(bad, w, FFT_LEN, site="stream.realize")


def test_checksum_weights_deterministic_and_bounded():
    w1, w2 = abft.checksum_weights(32, seed=5), abft.checksum_weights(32, 5)
    assert np.array_equal(w1, w2) and w1.dtype == np.float32
    assert float(w1.min()) >= 0.5 and float(w1.max()) <= 1.5
    assert not np.array_equal(w1, abft.checksum_weights(32, seed=6))


def test_silent_corruption_is_retryable_ioerror():
    err = abft.SilentCorruption("x", site="stream.realize", index=1)
    assert isinstance(err, IOError)
    # the blockstore/stream policies restrict retryable to I/O classes;
    # SilentCorruption must still qualify so quarantine == retry
    assert RetryPolicy(retryable=(IOError, OSError)).retryable_exc(err)


def test_cost_model_off_parseval_abft():
    assert abft.verify_flops("off", FFT_LEN, 8) == 0
    assert abft.verify_hbm_bytes("off", FFT_LEN, 8) == 0
    assert abft.verify_flops("parseval", FFT_LEN, 0) == 0
    # abft's combination+residual passes cost more flops than the energy
    # reductions, on the same two extra plane reads
    assert abft.verify_flops("abft", FFT_LEN, 8) > \
        abft.verify_flops("parseval", FFT_LEN, 8) > 0
    assert abft.verify_hbm_bytes("abft", FFT_LEN, 8) == \
        abft.verify_hbm_bytes("parseval", FFT_LEN, 8) > 0


# ---------------------------------------------------------------------------
# corrupt fault rules: schedule, spec grammar, determinism


def test_corrupt_rule_validation():
    assert KINDS == ("raise", "corrupt")
    with pytest.raises(ValueError, match="kind"):
        FaultRule("stream.realize", 0, kind="flip")
    with pytest.raises(ValueError, match="scale"):
        FaultRule("stream.realize", 0, kind="corrupt", scale=0.0)
    with pytest.raises(ValueError, match="kind"):
        FaultPlan.random(0, 4, kind="flip")


def test_corrupt_parse_and_to_spec_roundtrip():
    plan = FaultPlan.parse(
        "seed=7,rate=0.5,sites=stream.realize+ooc.shuffle,kind=corrupt",
        num_blocks=16)
    assert plan.rules and all(r.kind == "corrupt" for r in plan.rules)
    assert all(0.25 <= r.scale <= 4.0 for r in plan.rules)
    # to_spec emits explicit rules (scales included): replays exactly,
    # independent of the parser's num_blocks
    again = FaultPlan.parse(plan.to_spec(), num_blocks=0)
    assert again.rules == plan.rules


def test_corrupt_storm_targets_match_raise_storm():
    """Same seed -> same (site, block) hit pattern for both kinds: a raise
    storm can be re-run as silent corruption without reshuffling."""
    sites = ("stream.realize", "ooc.shuffle")
    for seed in (0, 7, 1407):
        hit = FaultPlan.random(seed, 32, sites=sites, rate=0.3)
        corr = FaultPlan.random(seed, 32, sites=sites, rate=0.3,
                                kind="corrupt")
        assert {(r.site, r.index) for r in hit.rules} == \
            {(r.site, r.index) for r in corr.rules}


def test_perturbation_deterministic_and_norm_relative(rng):
    a = rng.standard_normal(512).astype(np.float32)
    salt = corrupt_salt("stream.realize", 9)
    b1 = perturb_array(a.copy(), 1.0, salt)
    b2 = perturb_array(a.copy(), 1.0, salt)
    assert np.array_equal(b1, b2)               # pure function of salt
    assert not np.array_equal(b1, perturb_array(a.copy(), 1.0, salt + 1))
    # exactly one element moved, by O(scale * ||a||): provably above any
    # eps-derived tolerance regardless of n
    changed = np.flatnonzero(b1 != a)
    assert changed.size == 1
    delta = abs(float(b1[changed[0]] - a[changed[0]]))
    assert delta >= 0.5 * (1.0 + float(np.linalg.norm(a))) * 0.9


# ---------------------------------------------------------------------------
# end-to-end quarantine-and-recompute


def _store(tmp_path, rng, blocks=4):
    sig = rng.standard_normal(
        (SEG_PER_BLOCK * blocks, FFT_LEN, 2)).astype(np.float32)
    store = BlockStore(tmp_path / "in",
                       block_bytes=segment_block_bytes(FFT_LEN,
                                                       SEG_PER_BLOCK))
    store.put_bytes(sig.tobytes())
    return store


def _stream_run(store, out_dir, injector, verify):
    cfg = JobConfig(readers=2, writers=2, coalesce=2, inflight=2,
                    speculation=False, max_retries=4, injector=injector)
    store.injector = injector
    job = MapOnlyJob(store, out_dir, config=cfg, pipelined=True,
                     transform=SegmentFFTTransform(FFT_LEN, impl="ref",
                                                   verify=verify,
                                                   device="cpu"))
    stats = job.run()
    job.merge(out_dir.parent / f"{out_dir.name}.bin")
    return stats, (out_dir.parent / f"{out_dir.name}.bin").read_bytes()


def test_stream_abft_detects_and_recovers_bitwise(tmp_path, rng):
    store = _store(tmp_path, rng)
    _, clean = _stream_run(store, tmp_path / "clean", None, "abft")

    storm = FaultPlan((FaultRule("stream.realize", 1, kind="corrupt",
                                 scale=2.0),))
    clear_events()
    inj = FaultInjector(storm)
    stats, got = _stream_run(store, tmp_path / "storm", inj, "abft")
    assert inj.total_corrupted == 1
    assert len(events("verify_failed")) >= 1
    assert stats.retries >= 1 and not stats.failed_blocks
    assert got == clean  # recompute restored the clean bytes

    # negative control: the same storm with verify off sails through every
    # byte check — wrong output, zero retries
    stats_off, off = _stream_run(store, tmp_path / "off",
                                 FaultInjector(storm), "off")
    assert off != clean and stats_off.retries == 0


def test_stream_parseval_quarantines_only_the_member(tmp_path, rng):
    store = _store(tmp_path, rng)
    _, clean = _stream_run(store, tmp_path / "clean", None, "parseval")
    clear_events()
    stats, got = _stream_run(
        store, tmp_path / "storm",
        FaultInjector(FaultPlan((FaultRule("stream.realize", 2,
                                           kind="corrupt"),))), "parseval")
    assert len(events("verify_failed")) == 1
    assert stats.retries == 1  # member-granular: one block requeued
    assert got == clean


def test_maponly_serial_verify_fn_catches_post_map_corruption(tmp_path,
                                                              rng):
    store = _store(tmp_path, rng)
    runs = iter(range(10))  # unique per-run dirs

    def run(injector, verify_fn):
        i = next(runs)
        cfg = JobConfig(workers=2, max_retries=4, injector=injector,
                        verify_fn=verify_fn)
        store.injector = injector
        job = MapOnlyJob(store, tmp_path / f"out{i}",
                         serial_map_fn(FFT_LEN, "ref", lambda s, t0: t0,
                                       device="cpu"), cfg)
        stats = job.run()
        job.merge(tmp_path / f"m{i}.bin")
        return stats, (tmp_path / f"m{i}.bin").read_bytes()

    _, clean = run(None, None)
    storm = FaultPlan((FaultRule("maponly.attempt", 0, kind="corrupt"),))
    clear_events()
    stats, got = run(FaultInjector(storm), parseval_verify_fn(FFT_LEN))
    assert len(events("verify_failed")) == 1
    assert stats.retries >= 1 and got == clean
    # without the hook the corrupted bytes are written as-is
    stats_off, off = run(FaultInjector(storm), None)
    assert stats_off.retries == 0 and off != clean


# ---------------------------------------------------------------------------
# plan cache: verify is part of the key; counters stay exact under races


def test_verify_resolved_into_plan_cache_key():
    fft_api.clear_plan_cache()
    kw = dict(kind="c2c", n=FFT_LEN, batch_shape=(4,), impl="ref",
              device="cpu")
    p_off = fft_api.plan(**kw)
    p_ver = fft_api.plan(**kw, verify="abft")
    assert p_off is not p_ver
    assert (p_off.spec.verify, p_ver.spec.verify) == ("off", "abft")
    assert fft_api.plan(**kw, verify="abft") is p_ver
    with pytest.raises(ValueError, match="verify"):
        fft_api.plan(**kw, verify="bogus")


def test_plan_cache_counters_exact_under_concurrent_plan_calls():
    """Stream dispatchers plan concurrently in one process: cache counters
    must reconcile exactly (hits + misses == calls, one miss per distinct
    resolved spec) — the get-or-build is a single critical section, not
    check-then-insert."""
    fft_api.clear_plan_cache()
    keys = [dict(kind="c2c", n=FFT_LEN, batch_shape=(rows,), impl="ref",
                 verify=v, device="cpu")
            for rows in (4, 9) for v in ("off", "abft")]
    iters, nthreads = 8, 6
    start = threading.Barrier(nthreads)
    errors = []

    def worker(tid):
        try:
            start.wait()
            for i in range(iters):
                kw = keys[(tid + i) % len(keys)]
                p = fft_api.plan(**kw)
                assert p.spec.verify == kw["verify"]
        except BaseException as e:  # surface failures from threads
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    info = fft_api.cache_info()
    calls = iters * nthreads
    assert info["entries"] == len(keys)
    assert info["misses"] == len(keys)  # each spec built exactly once
    assert info["hits"] == calls - len(keys)


# ---------------------------------------------------------------------------
# BlockStore structured integrity errors


def _bstore(tmp_path, nblocks=3):
    store = BlockStore(tmp_path / "s", block_bytes=BB)
    store.put_bytes(os.urandom(BB * nblocks))
    return store


def test_is_retryable_ioerror():
    err = BlockIntegrityError("boom", index=7, block="block_x.bin")
    assert isinstance(err, IOError)
    assert (err.index, err.block) == (7, "block_x.bin")


def test_read_block_corruption_names_block(tmp_path):
    store = _bstore(tmp_path)
    (store.root / store.blocks[1].name()).write_bytes(b"\0" * BB)
    with pytest.raises(BlockIntegrityError) as ei:
        store.read_block(1)
    assert ei.value.index == 1
    assert ei.value.block == store.blocks[1].name()
    # the root cause (the per-replica checksum failure) stays chained
    assert isinstance(ei.value.__cause__, IOError)


def test_put_file_failure_names_block(tmp_path, monkeypatch):
    store = BlockStore(tmp_path / "s", block_bytes=BB)
    src = tmp_path / "src.bin"
    src.write_bytes(os.urandom(4 * BB))
    orig = store._append_block

    def flaky(off, chunk):  # disk fills up two blocks in
        if off >= 2 * BB:
            raise OSError(28, "No space left on device")
        return orig(off, chunk)

    monkeypatch.setattr(store, "_append_block", flaky)
    with pytest.raises(BlockIntegrityError) as ei:
        store.put_file(src)
    assert ei.value.index == 2
    assert ei.value.block == f"block_{2 * BB:016d}.bin"
    assert isinstance(ei.value.__cause__, OSError)


def test_put_chunks_splits_as_concatenated_and_rejects_mid_block_ends(
        tmp_path):
    data = os.urandom(5 * BB + 100)
    whole = BlockStore(tmp_path / "whole", block_bytes=BB)
    whole.put_bytes(data)
    parts = BlockStore(tmp_path / "parts", block_bytes=BB)
    parts.put_chunks([data[:2 * BB], data[2 * BB:4 * BB], data[4 * BB:]])
    assert parts.total_bytes == whole.total_bytes == len(data)
    assert [vars(b) for b in parts.blocks] == [vars(b) for b in whole.blocks]
    with pytest.raises(ValueError, match="mid-block"):
        parts.put_chunks([data[:BB + 1], data[BB + 1:]])


@pytest.mark.parametrize("how", ["missing", "unreadable"])
def test_getmerge_failure_names_block(tmp_path, how):
    store = _bstore(tmp_path)
    out = tmp_path / "out"
    for i in range(3):
        if how == "missing" and i == 1:
            continue  # block 1 never written
        store.write_output_block(out, i, b"y" * BB)
    if how == "unreadable":
        # block 1 lists fine but fails on open (vanished into a directory)
        victim = out / store.blocks[1].name()
        victim.unlink()
        victim.mkdir()
    with pytest.raises(BlockIntegrityError) as ei:
        store.getmerge(out, tmp_path / "merged.bin")
    assert ei.value.index == 1
    assert ei.value.block == store.blocks[1].name()
    if how == "unreadable":
        assert isinstance(ei.value.__cause__, OSError)
