"""The port's FFT service (`repro_torch.serve`) against the JAX package's.

Mirrors the 19 tests of tests/test_fft_service.py and the serve cases of
tests/test_verify.py, each under impl "matfft" (the kernels' plain
PyTorch versions on the CPU) and "ref" (torch.fft); adds the reference's
serve gate (benchmarks/bench_serve.py's storm, every ``ok`` bitwise equal
to the loadgen oracle), a parity case against the reference's service on
the same loadgen seed (each ``ok`` result within 5e-6), the batch
invariance of the port's kernels (ROADMAP Queue 1 item 9) and the
`fft_serve --device cpu` launcher. The device-loss case runs on a
world-size-1 gloo group. A service over two ranks runs once per module,
as two subprocesses of this file on a gloo group (``python
test_torch_service.py rank <rank> <store> <dir>``): a follower's submit
raises, an idle gap past the control channel's timeout keeps the
follower alive, and its close waits for rank 0's stop. The 8-rank cases
are in tests/test_torch_distributed.py.
"""

import contextlib
import datetime
import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.fft as fft_api
from repro_torch.core.resilience import (FaultInjector, FaultPlan,
                                         RetryPolicy, clear_events, events,
                                         meshstate)
from repro_torch.core.resilience.faults import FaultRule, InjectedFault
from repro_torch.serve import loadgen
from repro_torch.serve.fft_service import (MSG_BYTES, DeadlineExceeded,
                                           FftService, RequestFailed,
                                           ServiceClosed, ServiceError,
                                           ServiceOverload, decode_message,
                                           encode_message)

# the suite runs one process per core (xdist): keep torch to one thread
torch.set_num_threads(1)

N = 128  # small pow2 so every launch is instant on CPU
TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)


@pytest.fixture(params=["matfft", "ref"])
def impl(request):
    return request.param


def _ops(rows, n=N, kind="c2c", seed=0):
    rng = np.random.default_rng(seed)
    dims = (rows, n) if rows else (n,)
    if kind == "c2c":
        return (rng.standard_normal(dims, dtype=np.float32),
                rng.standard_normal(dims, dtype=np.float32))
    return (rng.standard_normal(dims, dtype=np.float32),)


@pytest.fixture
def service_of(impl):
    def make(**kw):
        kw.setdefault("impl", impl)
        kw.setdefault("device", "cpu")
        return FftService(**kw)
    return make


# ------------------------------------------------------------------ results


def test_c2c_and_r2c_round_trip_bitwise(service_of):
    with service_of() as service:
        tc = service.submit("c2c", *_ops(2))
        tr = service.submit("r2c", *_ops(2, kind="r2c", seed=1))
        cr, ci = tc.result(timeout=30)
        want = np.fft.fft(_ops(2)[0] + 1j * _ops(2)[1], axis=-1)
        np.testing.assert_allclose(cr + 1j * ci, want, rtol=1e-4, atol=1e-3)
        rr, ri = tr.result(timeout=30)
        wantr = np.fft.rfft(_ops(2, kind="r2c", seed=1)[0], axis=-1)
        np.testing.assert_allclose(rr + 1j * ri, wantr, rtol=1e-4, atol=1e-3)
        assert tc.timings["total_s"] > 0 and tc.batch_rows >= 2


def test_single_row_operand_is_squeezed_back(service_of):
    with service_of() as service:
        t = service.submit("c2c", *_ops(0))       # 1-D operands, no batch
        xr, xi = t.result(timeout=30)
        assert xr.shape == (N,) and xi.shape == (N,)


def test_coalescing_uses_at_most_two_plans_per_key(service_of, impl):
    fft_api.clear_plan_cache()
    service = service_of(coalesce=4, start=False)
    tickets = [service.submit("c2c", *_ops(2, seed=i)) for i in range(5)]
    service.start()
    service.close(drain=True)
    # FIFO grouping: the first 4 form the full batch, the 5th launches as
    # a singleton after max_batch_delay_s — the 2-plan full/tail trick
    assert [t.batch_rows for t in tickets] == [8, 8, 8, 8, 2]
    assert fft_api.cache_info()["entries"] <= 2
    # coalesced and singleton results both match the fault-free oracle
    # replayed at the same launch batch size, bit for bit
    shape = loadgen.RequestShape("c2c", N, 2)
    for i, t in enumerate(tickets):
        want = loadgen.oracle(shape, _ops(2, seed=i), impl=impl,
                              batch_rows=t.batch_rows, device="cpu")
        assert loadgen.bitwise_equal(t.result(), want)


# ---------------------------------------------------------------- admission


def test_queue_depth_bounds_admission(service_of):
    service = service_of(queue_depth=4, start=False)
    tickets = [service.submit("c2c", *_ops(2, seed=i)) for i in range(6)]
    rejected = [t for t in tickets if t.error is not None]
    assert len(rejected) == 2
    for t in rejected:
        assert isinstance(t.error, ServiceOverload)
        assert t.error.reason == "queue_full"
        assert t.error.as_dict()["reason"] == "queue_full"
    assert service.stats.admitted == 4
    assert service.stats.rejected == {"queue_full": 2}
    service.start()
    service.close(drain=True)
    assert all(t.error is None for t in tickets[:4])
    assert service.idle()


def test_per_spec_token_bucket_rate_limits(service_of):
    service = service_of(per_spec_qps=1e-6, per_spec_burst=2, start=False)
    tickets = [service.submit("c2c", *_ops(2, seed=i)) for i in range(4)]
    reasons = [t.error.reason for t in tickets if t.error is not None]
    assert reasons == ["rate_limit", "rate_limit"]
    # a different spec key has its own bucket
    assert service.submit("r2c", *_ops(2, kind="r2c")).error is None
    service.start()
    service.close(drain=True)


def test_per_spec_inflight_cap(service_of):
    service = service_of(per_spec_inflight=1, start=False)
    t1 = service.submit("c2c", *_ops(2))
    t2 = service.submit("c2c", *_ops(2, seed=1))
    other = service.submit("r2c", *_ops(2, kind="r2c"))
    assert t1.error is None and other.error is None
    assert isinstance(t2.error, ServiceOverload)
    assert t2.error.reason == "inflight_cap"
    service.start()
    service.close(drain=True)
    # the slot freed at completion: admission works again
    assert service.stats.admitted == 2


def test_submit_validation_is_synchronous(service_of):
    with service_of(start=False) as service:
        with pytest.raises(ValueError, match="kind"):
            service.submit("dct", *_ops(2))
        with pytest.raises(ValueError, match="operand"):
            service.submit("c2c", _ops(2)[0])          # c2c needs xr, xi
        with pytest.raises(ValueError, match="shapes differ"):
            service.submit("c2c", np.zeros((2, N), np.float32),
                           np.zeros((3, N), np.float32))
        with pytest.raises(ValueError):
            service.submit("c2c", *_ops(2, n=100))     # not a power of two


# ---------------------------------------------------------------- deadlines


def test_deadline_shed_before_launch_with_breakdown(service_of):
    service = service_of(default_deadline_s=0.002, start=False)
    tickets = [service.submit("c2c", *_ops(2, seed=i)) for i in range(3)]
    time.sleep(0.05)          # every deadline lapses while nothing runs
    service.start()           # the sweep sheds the whole backlog
    service.close(drain=True)
    for t in tickets:
        err = t.error
        assert isinstance(err, DeadlineExceeded)
        assert err.stage == "queue"
        assert err.queue_s > 0 and err.execute_s == 0.0
        d = err.as_dict()
        assert d["deadline_s"] == pytest.approx(0.002)
        with pytest.raises(DeadlineExceeded):
            t.result()
    assert service.stats.deadline_exceeded == 3


# ------------------------------------------------------------ faults, retry


def test_batch_fault_retries_then_succeeds(service_of):
    # one member faults on its FIRST serve.batch pass: the whole group
    # fails (fire_group semantics), every member retries, relaunch clean
    rules = (FaultRule("serve.batch", 0, (1,)),)
    injector = FaultInjector(FaultPlan(rules))
    service = service_of(injector=injector, coalesce=4, start=False,
                         retry=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    tickets = [service.submit("c2c", *_ops(2, seed=i)) for i in range(4)]
    service.start()
    service.close(drain=True)
    for t in tickets:
        assert t.error is None and t.attempts == 2
    assert service.stats.retries == 4
    assert injector.fired["serve.batch"] >= 1


class _SlotsBusyOnce:
    """The in-flight slots, seen full on the batcher's second wait only."""

    def __init__(self, slots):
        self.slots, self.calls = slots, 0

    def acquire(self, timeout=None):
        self.calls += 1
        return self.calls != 2 and self.slots.acquire(timeout=timeout)

    def release(self):
        self.slots.release()


def test_retry_routed_while_a_partial_group_waits_is_served(service_of):
    # the full group [0, 1] faults at serve.batch and routes both members
    # back; the partial group [2] then waits one poll for a slot, and the
    # batcher takes the retries in during that wait: they must stay
    # queued and launch again, not be cleared with the group they joined
    rules = (FaultRule("serve.batch", 0, (1,)),)
    service = service_of(injector=FaultInjector(FaultPlan(rules)),
                         coalesce=2, max_batch_delay_s=0.0, start=False,
                         retry=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    service._inflight = _SlotsBusyOnce(service._inflight)
    tickets = [service.submit("c2c", *_ops(2, seed=i)) for i in range(3)]
    service.start()
    service.close(drain=True)
    assert service._inflight.calls >= 4
    assert [t.wait(0) for t in tickets] == [True] * 3
    assert [t.error for t in tickets] == [None] * 3
    assert [t.attempts for t in tickets] == [2, 2, 1]
    assert service.stats.retries == 2 and service.idle()


def test_retry_budget_exhaustion_chains_the_cause(service_of):
    # request 0 faults on every serve.batch pass; budget of 2 attempts
    rules = (FaultRule("serve.batch", 0, tuple(range(1, 10))),)
    service = service_of(injector=FaultInjector(FaultPlan(rules)),
                         retry=RetryPolicy(max_attempts=2, base_delay_s=0.0),
                         start=False)
    t = service.submit("c2c", *_ops(2))
    service.start()
    service.close(drain=True)
    assert isinstance(t.error, RequestFailed)
    assert t.error.stage == "batch" and t.error.attempts == 2
    assert isinstance(t.error.__cause__, InjectedFault)
    assert "InjectedFault" in t.error.as_dict()["cause"]
    assert service.stats.failed == 1 and service.idle()


def test_execute_fault_is_retried_too(service_of):
    rules = (FaultRule("serve.execute", 0, (1,)),)
    service = service_of(injector=FaultInjector(FaultPlan(rules)),
                         retry=RetryPolicy(max_attempts=3, base_delay_s=0.0),
                         start=False)
    t = service.submit("c2c", *_ops(2))
    service.start()
    service.close(drain=True)
    assert t.error is None and t.attempts == 2
    assert service.stats.retries == 1


# ------------------------------------------------------- overload shedding


def test_sustained_overload_sheds_by_policy(service_of):
    clear_events()
    service = service_of(queue_depth=4, shed_after=2, shed_fraction=0.5,
                         shed_policy="oldest_deadline", start=False)
    admitted = [service.submit("c2c", *_ops(2, seed=i)) for i in range(4)]
    # hammer a full queue until the strike counter requests a shed
    for i in range(3):
        assert service.submit("c2c", *_ops(2, seed=9 + i)).error is not None
    service.start()
    service.close(drain=True)
    shed = [t for t in admitted
            if isinstance(t.error, ServiceOverload)
            and t.error.reason == "shed"]
    assert len(shed) == 2 == service.stats.shed  # ceil(0.5 * 4)
    # oldest_deadline with no deadlines falls back to submit (seq) order
    assert [t.seq for t in shed] == [0, 1]
    ev = events("service_degrade")
    assert ev and ev[-1]["reason"] == "overload"
    assert ev[-1]["policy"] == "oldest_deadline"


def test_shed_policy_validated(service_of):
    with pytest.raises(ValueError, match="shed_policy"):
        service_of(shed_policy="noisiest_neighbor", start=False)


# -------------------------------------------------------- degrade, recover


def test_batcher_crash_recovers_and_keeps_serving(service_of):
    clear_events()
    service = service_of(start=False)
    boom = {"armed": True}
    orig = service._sweep_deadlines

    def crashing_sweep():
        if boom.pop("armed", False):
            raise RuntimeError("batcher bug")
        orig()

    service._sweep_deadlines = crashing_sweep
    service.start()
    t = service.submit("c2c", *_ops(2))
    assert t.result(timeout=30) is not None
    assert service.stats.crash_recoveries >= 1
    recs = events("service_crash_recovered")
    assert recs and "batcher bug" in recs[-1]["error"]
    service.close(drain=True)


@contextlib.contextmanager
def _one_rank_group(tmp_path):
    """A world-size-1 gloo group and a one-rank ("x",) mesh over it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
    finally:
        fft_api.clear_plan_cache()  # its plans hold the group
        dist.destroy_process_group()


def test_device_loss_logs_degrade_and_keeps_serving(service_of, impl,
                                                    tmp_path):
    clear_events()
    with _one_rank_group(tmp_path) as mesh:
        service = service_of(mesh=mesh, placement="auto", degrade=True)
        try:
            assert service.submit("c2c", *_ops(2)).result(timeout=30)
            meshstate.lose_devices(mesh.mesh.reshape(-1).tolist())
            deadline = time.monotonic() + 10.0
            while (not events("service_degrade")
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            ev = events("service_degrade")
            assert ev and ev[-1]["reason"] == "device_loss"
            assert ev[-1]["action"] == "replan_fallback_degrade"
            assert service.stats.degrade_events >= 1
            # fallback="degrade" re-plans around the lost rank: serving
            t = service.submit("c2c", *_ops(2, seed=3))
            xr, xi = t.result(timeout=30)
            ref = _ops(2, seed=3)
            want = np.fft.fft(ref[0] + 1j * ref[1], axis=-1)
            np.testing.assert_allclose(xr + 1j * xi, want, rtol=1e-4,
                                       atol=1e-3)
            # the degraded local plan computes what the segmented one did
            oracle = loadgen.oracle(loadgen.RequestShape("c2c", N, 2), ref,
                                    impl=impl, batch_rows=t.batch_rows,
                                    device="cpu")
            assert loadgen.bitwise_equal((xr, xi), oracle)
            assert events("plan_downgrade")[-1]["resolved_placement"] == \
                "local"
        finally:
            service.close(drain=True)
            meshstate.restore_devices()


# ------------------------------------------------ a service over two ranks

# the control channel's timeout in the two-rank run: it also bounds the
# group's set-up and every shard, so it leaves room for a loaded host
IDLE_TIMEOUT_S = 3.0


@pytest.mark.parametrize("msg", [
    {"op": "noop", "lost": [], "epoch": 0},
    {"op": "launch", "lost": [6, 7], "epoch": 3, "kind": "r2c",
     "shape": [8, 512], "rows": 64, "devices": 4},
    {"op": "stop", "lost": list(range(512)), "epoch": 2 ** 40},
])
def test_control_message_codec_round_trips(msg):
    buf = encode_message(msg)
    assert buf.dtype == torch.uint8 and tuple(buf.shape) == (MSG_BYTES,)
    assert decode_message(buf.clone()) == msg


def test_control_message_larger_than_its_buffer_raises():
    with pytest.raises(ValueError, match="MSG_BYTES"):
        encode_message({"op": "noop", "pad": "x" * MSG_BYTES})


def _two_rank_worker(rank: int, store: str, out: str) -> None:
    """One rank of a two-rank service on a gloo group (`two_ranks`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        service = FftService(mesh=mesh, impl="matfft", device="cpu",
                             coalesce=2, start=False,
                             control_timeout_s=IDLE_TIMEOUT_S)
        doc = {"rank": service.rank}
        if rank == 0:
            service.start()
            tickets = [service.submit("c2c", *_ops(4, seed=0))]
            tickets[0].result(timeout=30)
            time.sleep(4 * IDLE_TIMEOUT_S)  # idle past the timeout
            tickets.append(service.submit("c2c", *_ops(4, seed=1)))
            tickets[1].result(timeout=30)
            service.close(drain=True)
            doc["mesh_seconds"] = service.mesh_seconds()
            shape = loadgen.RequestShape("c2c", N, 4)
            doc["bitwise"] = [loadgen.bitwise_equal(t.result(), loadgen.oracle(
                shape, _ops(4, seed=i), impl="matfft",
                batch_rows=t.batch_rows, device="cpu"))
                for i, t in enumerate(tickets)]
        else:
            try:
                service.submit("c2c", *_ops(4))
                doc["submit_error"] = None
            except ServiceError as e:
                doc["submit_error"] = str(e)
            t0 = time.monotonic()
            service.close()
            doc["close_s"] = time.monotonic() - t0
            doc["shard_launches"] = service.stats.batches
        Path(out, f"rank{rank}.json").write_text(json.dumps(doc))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks of a two-rank service, as subprocesses of this file; each
    writes what it saw."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src"),
         os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, __file__, "rank", str(r), str(tmp / "store"),
         str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]


def test_follower_submit_raises_only_rank0_admits(two_ranks):
    follower = two_ranks[1]
    assert follower["rank"] == 1
    assert "only rank 0 admits" in follower["submit_error"]


def test_idle_gap_past_the_channel_timeout_keeps_followers_alive(two_ranks):
    leader, follower = two_ranks
    # both launches were segmented, the second after the idle gap
    assert leader["bitwise"] == [True, True]
    assert follower["shard_launches"] == 2


def test_rank0_times_each_step_of_its_launches(two_ranks, service_of):
    steps = two_ranks[0]["mesh_seconds"]
    assert set(steps) == {"shard", "send", "scatter", "gather_wait"}
    assert all(v > 0 for v in steps.values())
    with service_of() as service:  # one rank: no channel
        assert service.mesh_seconds() is None


def test_follower_close_waits_for_rank0_stop(two_ranks):
    # the follower closed at once and returned only when rank 0 stopped
    # it, after the idle gap
    assert two_ranks[1]["close_s"] >= 4 * IDLE_TIMEOUT_S


# ------------------------------------------------------------------ closing


def test_close_without_drain_cancels_queued_requests(service_of):
    service = service_of(start=False)
    tickets = [service.submit("c2c", *_ops(2, seed=i)) for i in range(3)]
    service.close(drain=False)
    for t in tickets:
        assert isinstance(t.error, ServiceClosed)
    assert service.idle()


def test_submit_after_close_is_rejected_closed(service_of):
    service = service_of()
    service.close(drain=True)
    t = service.submit("c2c", *_ops(2))
    assert isinstance(t.error, ServiceClosed)
    assert service.stats.rejected.get("closed") == 1


def test_drain_waits_for_inflight_work(service_of):
    service = service_of(coalesce=2)
    tickets = [service.submit("c2c", *_ops(2, seed=i)) for i in range(8)]
    service.close(drain=True)
    assert all(t.done() for t in tickets)
    assert all(t.error is None for t in tickets)
    assert service.idle()
    snap = service.stats.snapshot()
    assert snap["completed"] == 8
    assert snap["latency"]["count"] == 8 and snap["latency"]["p99_ms"] > 0


def test_many_clients_concurrent_submission_is_safe(service_of):
    service = service_of(queue_depth=64, coalesce=4)
    results: list = []
    lock = threading.Lock()

    def client(cid):
        for i in range(8):
            t = service.submit("c2c", *_ops(2, seed=cid * 100 + i))
            with lock:
                results.append(t)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    service.close(drain=True)
    assert len(results) == 32
    ok = sum(1 for t in results if t.error is None)
    rej = sum(1 for t in results
              if isinstance(t.error, ServiceOverload))
    assert ok + rej == 32 and ok > 0
    assert service.stats.max_queued <= 64
    assert service.idle()


def test_warmup_plans_both_batch_sizes(service_of):
    fft_api.clear_plan_cache()
    with service_of(coalesce=4, verify="abft") as service:
        summary = service.warmup([{"kind": "c2c", "shape": N, "rows": 2},
                                  ("r2c", (N,), 2)])
        assert summary["specs"] == 2 and summary["plans"] == 4
        misses = fft_api.cache_info()["misses"]
        assert service.submit("c2c", *_ops(2)).result(timeout=30)
        assert fft_api.cache_info()["misses"] == misses


# --------------------------------------------- tests/test_verify.py's serve


def test_serve_abft_quarantines_group_and_recomputes(impl):
    rng = np.random.default_rng(0)
    shape = loadgen.RequestShape("c2c", 1024, 2)
    reqs = [tuple(rng.standard_normal((2, 1024)).astype(np.float32)
                  for _ in range(2)) for _ in range(4)]
    storm = FaultPlan((FaultRule("serve.execute", 0, kind="corrupt"),))
    clear_events()
    # the four requests are queued before the batcher starts, so it forms
    # two full groups of coalesce=2 whatever the host's timing: the
    # corrupted first launch holds two requests
    svc = FftService(impl=impl, device="cpu", coalesce=2,
                     injector=FaultInjector(storm), verify="abft",
                     start=False)
    tickets = [svc.submit("c2c", xr, xi) for xr, xi in reqs]
    svc.start()
    for t in tickets:
        assert t.wait(60)
    svc.close(drain=True)
    assert svc.stats.corruption_detected >= 1
    # checksum failures cannot name the culprit: the whole coalesced
    # group quarantined, then every member recomputed clean
    assert svc.stats.corruption_recomputed >= 2
    assert all(t.error is None for t in tickets)
    for t, ops in zip(tickets, reqs):
        want = loadgen.oracle(shape, ops, impl=impl,
                              batch_rows=t.batch_rows, device="cpu")
        for g, w in zip(t.value, want):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_plan_cache_counters_exact_beside_a_running_service(impl,
                                                            monkeypatch):
    """The serve batcher and other threads plan concurrently in one
    process: the cache counters reconcile exactly (hits + misses == plan
    calls, one miss per distinct resolved spec)."""
    fft_api.clear_plan_cache()
    calls = []
    real_plan = fft_api.plan

    def counted(*a, **kw):
        calls.append(1)
        return real_plan(*a, **kw)

    monkeypatch.setattr(fft_api, "plan", counted)
    keys = [dict(kind="c2c", n=1024, batch_shape=(rows,), impl=impl,
                 verify=v, device="cpu")
            for rows in (4, 9) for v in ("off", "abft")]
    start = threading.Barrier(4)
    errors = []

    def worker(tid):
        try:
            start.wait()
            for i in range(8):
                fft_api.plan(**keys[(tid + i) % len(keys)])
        except BaseException as e:  # surface failures from threads
            errors.append(e)

    with FftService(impl=impl, device="cpu", coalesce=4) as service:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        tickets = [service.submit("c2c", *_ops(2, n=1024, seed=i))
                   for i in range(12)]
        for t in threads:
            t.join()
        assert all(t.result(timeout=30) for t in tickets)
    assert not errors
    info = fft_api.cache_info()
    assert info["hits"] + info["misses"] == len(calls)
    assert info["misses"] == info["entries"]


# ------------------------------------------------------------ the serve gate


def test_storm_every_request_ok_bitwise_or_classified(impl):
    """benchmarks/bench_serve.py's storm: an open-loop flood through a
    seeded 25% fault storm over the three serve sites; every request is
    ``ok`` and bitwise equal to the oracle at its launch size, or a
    classified structured error; the service drains to idle."""
    seed, n_req = 1407, 96
    injector = FaultInjector(FaultPlan.random(
        seed, n_req, sites=("serve.admit", "serve.batch", "serve.execute"),
        rate=0.25))
    service = FftService(impl=impl, device="cpu", coalesce=4,
                         queue_depth=40, max_inflight=2, injector=injector,
                         retry=RetryPolicy(max_attempts=4, base_delay_s=0.0))
    records = loadgen.drive(service, num_requests=n_req, clients=3,
                            seed=seed)
    outcomes = {rec.rid: loadgen.classify(rec) for rec in records}
    service.close(drain=True)
    assert service.idle() and len(records) == n_req
    buckets = set(outcomes.values())
    assert buckets <= {"ok", "queue_full", "rate_limit", "inflight_cap",
                       "admit_fault", "closed", "shed", "deadline",
                       "failed"}, buckets
    assert "ok" in buckets and injector.total_fired > 0
    for rec in records:
        if outcomes[rec.rid] == "ok":
            want = loadgen.oracle(
                rec.shape, loadgen.request_operands(seed, rec.rid,
                                                    rec.shape),
                impl=impl, batch_rows=rec.ticket.batch_rows, device="cpu")
            assert loadgen.bitwise_equal(rec.ticket.value, want), rec.rid


def test_same_loadgen_seed_matches_the_reference_service():
    """One loadgen seed, no faults, through the JAX package's service and
    the port's (plain versions of the hand-written kernels): every
    request ``ok`` on both sides, each within 5e-6 of the other."""
    from repro.serve import FftService as JaxService
    from repro.serve import loadgen as jloadgen

    seed, n_req = 11, 24
    results = {}
    for name, make, lg in (
            ("port", lambda: FftService(impl="matfft", device="cpu",
                                        coalesce=4), loadgen),
            ("ref", lambda: JaxService(impl="matfft", coalesce=4),
             jloadgen)):
        service = make()
        records = lg.drive(service, num_requests=n_req, clients=2,
                           seed=seed)
        assert [lg.classify(r) for r in records] == ["ok"] * n_req
        service.close(drain=True)
        results[name] = [r.ticket.value for r in records]
    for got, want in zip(results["port"], results["ref"]):
        g = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1])
        w = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1])
        assert np.abs(g - w).max() / np.abs(w).max() < TOL


# ------------------------------------------- ROADMAP Queue 1 item 9: batch


@pytest.mark.parametrize("kind,n", [("c2c", 256), ("c2c", 1024),
                                    ("c2c", 1 << 15), ("r2c", 1024)])
@pytest.mark.parametrize("kernel", ["matfft", "stockham"])
def test_a_row_gives_the_same_bits_at_any_batch_size(kind, n, kernel):
    """The port's kernels (plain versions here) give every row the same
    bits alone and in batches of 3, 17 and 64, wherever it sits in the
    batch. torch.fft on the CPU does not (impl "ref" at 2^15 changes a
    lone row's bits), which is why the oracle keeps replaying the launch
    size."""
    rng = np.random.default_rng(n)
    big = [torch.from_numpy(rng.standard_normal((64, n), dtype=np.float32))
           for _ in range(2 if kind == "c2c" else 1)]

    def run(rows, first=0):
        p = fft_api.plan(kind=kind, n=n, batch_shape=(rows,), impl=kernel,
                         device="cpu")
        ops = [b[first:first + rows].contiguous() for b in big]
        return p.execute(*ops) if kind == "c2c" else p.execute_real(*ops)

    full = run(64)
    for rows, first in ((1, 0), (1, 37), (3, 5), (17, 40), (64, 0)):
        got = run(rows, first)
        for a, b in zip(got, full):
            assert torch.equal(a, b[first:first + rows]), (rows, first)


# ----------------------------------------------------------------- launcher


def test_fft_serve_launcher_on_the_cpu():
    from repro_torch.launch import fft_serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = fft_serve.main([
            "--device", "cpu", "--impl", "matfft", "--requests", "60",
            "--faults", "seed=7,rate=0.25,sites=serve.admit+serve.batch+"
                        "serve.execute"])
    assert json.loads(buf.getvalue()) == json.loads(json.dumps(report))
    assert report["drained_idle"] and report["requests"] == 60
    assert sum(report["outcomes"].values()) == 60
    assert "silent_drop" not in report["outcomes"]
    assert not any(k.startswith("unclassified") for k in report["outcomes"])
    assert report["faults"]["total_fired"] > 0


if __name__ == "__main__":
    # python test_torch_service.py rank <rank> <store> <out dir>
    _two_rank_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
