"""The port's out-of-core four-step (`repro_torch.core.fft.outofcore`)
against its own in-memory oracle and against the JAX package's, on the CPU
through the kernels' plain versions.

Streamed runs are tiny (2^12..2^14 points) but exercise the real path: an
on-disk BlockStore, both StreamExecutor passes, the shuffle journal and
the phase manifests. Inside the port the streamed output equals the
oracle bit for bit; across the packages it is held to the selftest's
5e-6. The crash-resume cases read the phase manifest after the crash and
assert only what it shows, so they do not depend on how far the other
jobs' threads got before the failed job stopped the run.
"""

import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.fft as jfft
from repro.core.fft import outofcore as jooc
from repro.core.pipeline import BlockStore as JBlockStore
from repro.core.pipeline import JobConfig as JJobConfig
from repro.launch import fft_job as jjob
import repro_torch.fft as tfft
from repro_torch.core.fft import outofcore as ooc
from repro_torch.core.fft.outofcore import (_near_square_split, corner_turn,
                                            factor_out_of_core,
                                            reference_out_of_core)
from repro_torch.core.pipeline import BlockStore, JobConfig
from repro_torch.core.pipeline.maponly import Manifest
from repro_torch.core.resilience import (FaultInjector, FaultPlan, FaultRule,
                                         clear_events, events)
from repro_torch.fft.spec import MAX_LOCAL_N
from repro_torch.kernels.fft import matfft as km
from repro_torch.kernels.fft import plan as kplan
from repro_torch.launch import fft_job

pytestmark = pytest.mark.outofcore

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)
N = 1 << 12          # 4096 points: n1 = n2 = 64
BUDGET = 8 * N // 4  # operand/4 -> multiple jobs per pass
IMPL = "matfft"


def _signal(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 2)).astype(np.float32)


def _make_store(tmp_path, sig, block_bytes=None, budget=BUDGET):
    f = factor_out_of_core(len(sig), budget)
    store = BlockStore(tmp_path / "in",
                       block_bytes=block_bytes or f.pass1_panel_bytes)
    store.put_bytes(sig.tobytes())
    return store


def _plan(tmp_path, store, n=N, cfg=None, impl=IMPL, verify="off"):
    return tfft.plan(kind="c2c", n=n, placement="out_of_core",
                     store=store, work_dir=tmp_path / "ooc",
                     budget_bytes=BUDGET, impl=impl, job_config=cfg,
                     verify=verify, device="cpu")


def _merged(p, tmp_path) -> bytes:
    dest = tmp_path / "merged.bin"
    p.merge(dest)
    return dest.read_bytes()


def _done(p, manifest: str, jobs: int) -> set:
    m = Manifest(p.work_dir / manifest, jobs)
    try:
        return set(m.done())
    finally:
        m.close()


def _crash_cfg(rule):
    return JobConfig(readers=2, writers=2, inflight=2, speculation=False,
                     max_retries=3,
                     injector=FaultInjector(FaultPlan((rule,))))


# ---------------------------------------------------------------------------
# factorization + analytic model


def test_factor_near_square_and_model():
    f = factor_out_of_core(1 << 20, 1 << 22)
    assert f.n1 * f.n2 == f.n and f.n2 in (f.n1, 2 * f.n1)
    assert f.t2 * f.pass1_jobs == f.n2
    assert f.t1 * f.pass2_jobs == f.n1
    assert f.passes == 2
    assert f.io_bytes == 4 * f.operand_bytes
    assert f.shuffle_bytes == 2 * f.operand_bytes
    assert f.working_set_bytes <= f.budget_bytes
    assert f.tiles == f.pass1_jobs * f.pass2_jobs


def test_factor_rejects_non_pow2_and_tiny_budget():
    with pytest.raises(ValueError, match="power of"):
        factor_out_of_core(1000, 1 << 20)
    with pytest.raises(ValueError, match="budget"):
        factor_out_of_core(1 << 20, 1 << 10)


def test_factor_rejects_block_not_tiling_panel():
    with pytest.raises(ValueError, match="block_bytes"):
        factor_out_of_core(1 << 12, BUDGET, block_bytes=3 * 256)


def test_pass_lengths_cap_at_max_local_n_not_max_leaf_squared():
    """The port's leaf is 4096 points, so MAX_LEAF**2 is 2^24; a pass
    runs a local plan, which the port takes to MAX_LOCAL_N = 2^28."""
    assert kplan.MAX_LEAF ** 2 < MAX_LOCAL_N == 1 << 28
    assert _near_square_split(1 << 56) == (1 << 28, 1 << 28)
    with pytest.raises(ValueError, match="MAX_LOCAL_N"):
        _near_square_split(1 << 57)


def _factor_or_error(fn, *args):
    try:
        return fn(*args).as_dict()
    except ValueError:
        return ValueError


@pytest.mark.parametrize("panel_scale", [1, 2, 4, 3, 0])
def test_factor_equals_reference_on_a_grid(panel_scale):
    """Pure integer arithmetic: the port's factorization equals the JAX
    package's exactly, ValueError cases included (non-pow2 and tiny n,
    budgets below one line, blocks that do not tile the panel, scales
    that are not powers of two or shrink panels below a row, and pass
    lengths past 2^28)."""
    ns = [1 << p for p in range(1, 59)] + [3, 1000, (1 << 20) + 1]
    budgets = [1 << 10, 3 << 12, 1 << 16, 1 << 20, 2 << 20, 256 << 20,
               1 << 30, 1 << 40]
    blocks = [None, 3 * 256, 4096, 1 << 20, 1 << 22]
    raised = set()
    for n in ns:
        for budget in budgets:
            for block in blocks:
                args = (n, budget, block, panel_scale)
                got = _factor_or_error(factor_out_of_core, *args)
                want = _factor_or_error(jooc.factor_out_of_core, *args)
                assert got == want, args
                raised.add(got is ValueError)
    # a bad scale always raises; a good one both factors and raises
    assert raised == ({True} if panel_scale in (3, 0) else {True, False})


def test_out_of_core_entry_points_default_to_the_ported_kernels(tmp_path):
    # built directly, without plan(), the passes still run K1/K2, never
    # the library FFT ("ref") unless the caller asks for it
    store = _make_store(tmp_path, _signal())
    f = factor_out_of_core(N, BUDGET)
    direct = ooc.OutOfCorePlan(f, store, tmp_path / "a", device="cpu")
    bound = ooc.plan_out_of_core(N, store, tmp_path / "b", BUDGET,
                                 device="cpu")
    assert direct.impl == bound.impl == "matfft"
    assert inspect.signature(reference_out_of_core).parameters[
        "impl"].default == "matfft"


def test_planner_validates_out_of_core_args(tmp_path):
    store = _make_store(tmp_path, _signal())
    kw = dict(n=N, placement="out_of_core", store=store,
              work_dir=tmp_path / "o", budget_bytes=BUDGET, device="cpu")
    with pytest.raises(ValueError, match="out_of_core"):
        tfft.plan(kind="r2c", **kw)
    with pytest.raises(ValueError, match="batch_shape"):
        tfft.plan(kind="c2c", batch_shape=(2,), **kw)
    with pytest.raises(ValueError, match="ONE 1-D signal"):
        tfft.plan(kind="c2c", **{**kw, "n": None, "shape": (64, 64)})
    # tune=True validates the same arguments first, then picks the panel
    # height (the tuner's out-of-core knob) and binds the plan to it
    with pytest.raises(ValueError, match="out_of_core"):
        tfft.plan(kind="r2c", tune=True, **kw)
    tuned = tfft.plan(kind="c2c", tune=True,
                      wisdom_path=tmp_path / "wisdom.json", **kw)
    # the store's blocks are one full panel each, so smaller panels would
    # split a block: panel_scale 1 is the only candidate
    assert tuned.factors == factor_out_of_core(
        N, BUDGET, block_bytes=store.block_bytes)
    with pytest.raises(ValueError, match="store"):
        tfft.plan(kind="c2c", n=N, placement="out_of_core",
                  work_dir=tmp_path / "o", budget_bytes=BUDGET, device="cpu")
    # store= without the placement is an error, not silently ignored
    for extra in (dict(store=store), dict(work_dir=tmp_path / "o"),
                  dict(budget_bytes=BUDGET)):
        with pytest.raises(ValueError, match="placement"):
            tfft.plan(kind="c2c", n=N, device="cpu", **extra)


def test_out_of_core_without_a_card_raises_before_any_work(tmp_path,
                                                          monkeypatch):
    sig = _signal()
    store = _make_store(tmp_path, sig)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfft.plan(kind="c2c", n=N, placement="out_of_core", store=store,
                  work_dir=tmp_path / "ooc", budget_bytes=BUDGET)
    assert not (tmp_path / "ooc").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reference_out_of_core(sig, factor_out_of_core(N, BUDGET))


# ---------------------------------------------------------------------------
# layout contract + numerics


def test_corner_turn_identity_vs_numpy(tmp_path):
    """out == T(np.fft.fft(T(s))): the decimated-in/transposed-out
    contract, checked against numpy at float32-appropriate tolerance."""
    sig = _signal()
    store = _make_store(tmp_path, sig)
    p = _plan(tmp_path, store)
    p.execute()
    got = np.frombuffer(_merged(p, tmp_path), np.float32).reshape(N, 2)
    got = got[:, 0] + 1j * got[:, 1]
    s = (sig[:, 0] + 1j * sig[:, 1]).astype(np.complex128)
    want = corner_turn(np.fft.fft(corner_turn(s, p.factors)), p.factors)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    assert np.abs(got - want).max() / np.abs(want).max() < TOL


@pytest.mark.parametrize("impl", ["matfft", "ref"])
def test_streamed_bitwise_equals_oracle(tmp_path, impl):
    sig = _signal()
    store = _make_store(tmp_path, sig)
    p = _plan(tmp_path, store, impl=impl)
    km.reset_counts()
    stats = p.execute()
    if impl == "matfft":  # the passes ran the kernels' plain versions
        assert km.matfft_plain.calls == (p.factors.pass1_jobs
                                         + p.factors.pass2_jobs)
    assert _merged(p, tmp_path) == reference_out_of_core(
        sig, p.factors, impl=impl, device="cpu")
    assert stats.pass1_attempts == p.factors.pass1_jobs
    assert stats.io["total"] == p.factors.io_bytes


def test_multi_block_panels(tmp_path):
    """Panels spanning several store blocks read block-granular."""
    sig = _signal()
    f = factor_out_of_core(N, BUDGET)
    store = _make_store(tmp_path, sig, block_bytes=f.pass1_panel_bytes // 4)
    p = _plan(tmp_path, store)
    p.execute()
    assert _merged(p, tmp_path) == reference_out_of_core(
        sig, f, impl=IMPL, device="cpu")


@pytest.mark.parametrize("impl,n", [("ref", 1 << 14), ("matfft", 1 << 12)])
def test_port_matches_reference_out_of_core(tmp_path, impl, n):
    """Same store bytes through both packages' out-of-core plans: the
    twiddle is bit-identical, so the difference is the FFTs' alone. The
    reference runs its Pallas kernels in interpret mode at n = 2^12."""
    sig = _signal(n, seed=3)
    budget = 8 * n // 2  # two jobs a pass: few interpret-mode launches
    f = factor_out_of_core(n, budget)
    store = BlockStore(tmp_path / "in", block_bytes=f.pass1_panel_bytes)
    store.put_bytes(sig.tobytes())
    p = tfft.plan(kind="c2c", n=n, placement="out_of_core", store=store,
                  work_dir=tmp_path / "port", budget_bytes=budget, impl=impl,
                  device="cpu")
    p.execute()
    p.merge(tmp_path / "port.bin")
    jp = jfft.plan(kind="c2c", n=n, placement="out_of_core",
                   store=JBlockStore.open(tmp_path / "in"),
                   work_dir=tmp_path / "ref", budget_bytes=budget, impl=impl,
                   job_config=JJobConfig(readers=2, writers=2, inflight=2,
                                         speculation=False))
    jp.execute()
    jp.merge(tmp_path / "ref.bin")
    assert jp.factors.as_dict() == p.factors.as_dict()

    def planes(path):
        v = np.frombuffer(Path(path).read_bytes(), np.float32).reshape(n, 2)
        return v[:, 0] + 1j * v[:, 1]

    got, want = planes(tmp_path / "port.bin"), planes(tmp_path / "ref.bin")
    assert np.abs(got - want).max() / np.abs(want).max() < TOL


# ---------------------------------------------------------------------------
# crash-resume: the two-phase manifest protocol


def test_resume_mid_shuffle_redoes_only_lost_jobs(tmp_path):
    """Kill one pass-1 job's scatter past its retry budget; the resumed
    run re-runs exactly the jobs the manifest does not show DONE (the
    victim among them: FAILED demotes to PENDING on the new invocation)
    and merges bitwise output."""
    sig = _signal()
    store = _make_store(tmp_path, sig)
    f = factor_out_of_core(N, BUDGET)
    victim = f.pass1_jobs // 2
    p = _plan(tmp_path, store, cfg=_crash_cfg(FaultRule(
        site="ooc.shuffle", index=victim * f.pass1_jobs + victim,
        calls=(1, 2, 3, 4))))
    with pytest.raises(RuntimeError, match="failed"):
        p.execute()  # the exhausted job aborts the run mid-shuffle
    # and the pass-2 guard refuses the incomplete shuffle independently
    with pytest.raises(RuntimeError, match="complete shuffle"):
        p.run_pass2()
    done = _done(p, "pass1_manifest.json", f.pass1_jobs)
    assert victim not in done

    p2 = _plan(tmp_path, store)
    stats = p2.execute()
    assert stats.pass1_attempts == f.pass1_jobs - len(done) >= 1
    assert _done(p2, "pass1_manifest.json", f.pass1_jobs) == \
        set(range(f.pass1_jobs))
    assert stats.pass2_attempts == f.pass2_jobs
    assert _merged(p2, tmp_path) == reference_out_of_core(
        sig, f, impl=IMPL, device="cpu")


def test_resume_between_phases_redoes_no_pass1_work(tmp_path):
    """Crash after the shuffle completed: resume runs zero pass-1
    attempts and streams pass 2 from the journaled tiles."""
    sig = _signal()
    store = _make_store(tmp_path, sig)
    p = _plan(tmp_path, store)
    p.run_pass1()  # "crash" here: phase 1 durable, phase 2 never started

    p2 = _plan(tmp_path, store)
    stats = p2.execute()
    assert stats.pass1_attempts == 0
    assert stats.pass2_attempts == p2.factors.pass2_jobs
    assert _merged(p2, tmp_path) == reference_out_of_core(
        sig, p2.factors, impl=IMPL, device="cpu")


def test_resume_mid_pass2_redoes_only_unfinished(tmp_path):
    """Kill one pass-2 tile gather past its retries: the resumed run
    re-runs no pass-1 work and exactly the pass-2 jobs the manifest does
    not show DONE, the victim among them."""
    sig = _signal()
    store = _make_store(tmp_path, sig)
    f = factor_out_of_core(N, BUDGET)
    victim = f.pass2_jobs // 2
    p = _plan(tmp_path, store, cfg=_crash_cfg(FaultRule(
        site="ooc.pass2", index=victim * f.pass1_jobs, calls=(1, 2, 3, 4))))
    with pytest.raises(RuntimeError, match="failed"):
        p.execute()  # pass 1 + shuffle complete; one pass-2 job dies
    assert len(_done(p, "pass1_manifest.json", f.pass1_jobs)) == \
        f.pass1_jobs
    done = _done(p, "pass2_manifest.json", f.pass2_jobs)
    assert victim not in done

    p2 = _plan(tmp_path, store)
    stats = p2.execute()
    assert stats.pass1_attempts == 0
    assert stats.pass2_attempts == f.pass2_jobs - len(done) >= 1
    assert _done(p2, "pass2_manifest.json", f.pass2_jobs) == \
        set(range(f.pass2_jobs))
    assert _merged(p2, tmp_path) == reference_out_of_core(
        sig, f, impl=IMPL, device="cpu")


def test_pass2_guard_requires_complete_shuffle(tmp_path):
    store = _make_store(tmp_path, _signal())
    p = _plan(tmp_path, store)
    with pytest.raises(RuntimeError, match="complete shuffle"):
        p.run_pass2()


def test_merge_requires_complete_output(tmp_path):
    store = _make_store(tmp_path, _signal())
    p = _plan(tmp_path, store)
    with pytest.raises(IOError, match="missing"):
        p.merge(tmp_path / "merged.bin")


# ---------------------------------------------------------------------------
# silent corruption in the shuffle: the energy chain catches it


@pytest.mark.parametrize("verify", ["parseval", "abft", "off"])
def test_verify_catches_corrupt_shuffle_tile(tmp_path, verify):
    """A ``kind=corrupt`` hit perturbs one tile after the scatter and
    before its CRC. Under "parseval" and "abft" the scatter-energy check
    fails, the pass-1 job retries and the output is bitwise clean; with
    verify off the corrupt tile sails through every byte check."""
    sig = _signal()
    store = _make_store(tmp_path, sig)
    f = factor_out_of_core(N, BUDGET)
    inj = FaultInjector(FaultPlan((FaultRule(
        site="ooc.shuffle", index=f.pass1_jobs + 1, kind="corrupt"),)))
    clear_events()
    p = _plan(tmp_path, store, cfg=JobConfig(
        readers=2, writers=2, inflight=2, speculation=False, max_retries=3,
        injector=inj), verify=verify)
    stats = p.execute()
    clean = reference_out_of_core(sig, f, impl=IMPL, device="cpu")
    assert inj.total_corrupted == 1
    if verify == "off":
        assert stats.pass1.retries == 0 and not events("verify_failed")
        assert _merged(p, tmp_path) != clean
    else:
        failed = events("verify_failed")
        assert len(failed) == 1 and failed[0]["site"] == "ooc.shuffle"
        assert stats.pass1.retries == 1
        assert _merged(p, tmp_path) == clean


# ---------------------------------------------------------------------------
# plan-cache observability (repro_torch.fft.cache_info)


def test_cache_info_counts_hits_and_misses(tmp_path):
    n = 1 << 13  # n1=64, n2=128: the two passes cache DISTINCT plans
    budget = 8 * n // 4
    tfft.clear_plan_cache()
    base = tfft.cache_info()
    assert base["entries"] == 0 and base["hits"] == 0
    f = factor_out_of_core(n, budget)
    store = BlockStore(tmp_path / "in", block_bytes=f.pass1_panel_bytes)
    store.put_bytes(_signal(n).tobytes())
    p = tfft.plan(kind="c2c", n=n, placement="out_of_core", store=store,
                  work_dir=tmp_path / "ooc", budget_bytes=budget, impl=IMPL,
                  device="cpu")
    p.execute()
    info = tfft.cache_info()
    # one cached plan per pass, re-hit by every subsequent job
    assert info["misses"] == 2 and info["entries"] == 2
    jobs = f.pass1_jobs + f.pass2_jobs
    assert info["hits"] == jobs - 2
    tfft.clear_plan_cache()
    assert tfft.cache_info()["entries"] == 0


# ---------------------------------------------------------------------------
# the launcher: fft_job --out-of-core


def test_ingest_slices_equal_one_draw(tmp_path, monkeypatch):
    """The launcher draws the operand in slices of one generator; the
    stored bytes equal a single draw of the whole operand."""
    n, seed = 1 << 14, 5
    monkeypatch.setattr(fft_job, "INGEST_POINTS", 1 << 10)
    store = BlockStore(tmp_path / "in", block_bytes=1 << 13)
    store.put_chunks(fft_job.operand_chunks(n, seed))
    assert len(store.blocks) == 16
    got = b"".join(store.read_block(i) for i in range(len(store.blocks)))
    want = np.random.default_rng(seed).standard_normal((n, 2))
    assert got == want.astype(np.float32).tobytes()


def test_fft_job_out_of_core_cli(tmp_path, capsys):
    """`fft_job --out-of-core --device cpu` end to end: the reference
    launcher's report keys plus the device, the
    ingested bytes equal to one draw of the seed, and the merged spectrum
    equal to the oracle bit for bit."""
    argv = ["--out-of-core", "--log2-n", "14", "--budget-mb", "1",
            "--seed", "2"]
    report = fft_job.main([*argv, "--device", "cpu",
                           "--work-dir", str(tmp_path / "port")])
    capsys.readouterr()
    jjob.main([*argv, "--impl", "ref", "--work-dir", str(tmp_path / "ref")])
    ref_report = json.loads(capsys.readouterr().out)
    assert set(report) == set(ref_report) | {"device", "device_name"}
    assert report["tuner"] is None  # no --tune: the tuner is not imported
    assert report["device"] == report["device_name"] == "cpu"
    assert report["factors"] == ref_report["factors"]
    assert report["stats"]["io"]["total"] == report["factors"]["io_bytes"]

    store = BlockStore.open(tmp_path / "port" / "in")
    sig = np.random.default_rng(2).standard_normal((1 << 14, 2))
    sig = sig.astype(np.float32)
    assert b"".join(store.read_block(i) for i in range(len(store.blocks))) \
        == sig.tobytes()
    f = factor_out_of_core(1 << 14, 1 << 20)
    assert (tmp_path / "port" / "merged.bin").read_bytes() == \
        reference_out_of_core(sig, f, impl="matfft", device="cpu")
