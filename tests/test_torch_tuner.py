"""The port's measuring autotuner and wisdom (`repro_torch.fft.tuner`),
against the JAX package's (`repro.fft.tuner`).

The 15 tests of tests/test_tuner.py through the port, with the same fake
measurer and the service warm-up cases (the mesh fingerprint on one-rank
meshes of an in-process gloo group: a mesh of other dims keys differently);
the gates of benchmarks/bench_tune.py as tests (tuned <= default on the
analytic and disk models, a wisdom round trip across two processes; the
3-D pencil's gate is in test_torch_distributed.py, which has 8 ranks); a
tuned port plan within 5e-6 of the reference's tuned plan and bitwise
equal to the port's default plan; the CUDA measurement shape of the chip's
specs; the layout candidates, offered only where a pass reads the layout;
and the facade selftest on the CPU.
"""

import datetime
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fft as fft_api
from repro_torch.fft import spec as tspec
from repro_torch.fft import tuner

events = importlib.import_module("repro_torch.core.resilience.events")

ROOT = Path(__file__).resolve().parents[1]
TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)


@pytest.fixture(autouse=True)
def _clean():
    fft_api.clear_plan_cache()
    tuner.reset_tune_stats()
    events.clear_events()
    yield
    fft_api.clear_plan_cache()


def _wisdom(tmp_path, name="wisdom.json"):
    return str(tmp_path / name)


def _fake_measurer():
    """A deterministic stand-in for the wall clock: a function of the
    candidate's knobs alone, so two sweeps agree exactly."""
    def measure(plan, cfg):
        s = plan.spec
        base = 1e-3 + plan.hbm_bytes * 1e-12
        if s.layout == "copy":
            base *= 1.5
        if s.overlap != "off":
            base *= 0.9 / (1 + 0.01 * int(s.overlap))
        return base
    return measure


KW = dict(kind="c2c", shape=(64, 256), batch_shape=(8,), device="cpu")


@pytest.fixture
def one_rank_group(tmp_path):
    """An in-process world-size-1 gloo group, for meshes of one rank."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        fft_api.clear_plan_cache()
        tuner._MESH_GROUPS.clear()
        dist.destroy_process_group()


# ---------------------------------------------------------------- tests/
# test_tuner.py through the port


class TestDeterminism:
    def test_same_seed_same_timer_same_winner(self, tmp_path):
        cfg = tuner.TuneConfig(seed=7, measurer=_fake_measurer())
        k1, r1 = tuner.tune(**KW, wisdom_path=_wisdom(tmp_path, "a.json"),
                            config=cfg)
        k2, r2 = tuner.tune(**KW, wisdom_path=_wisdom(tmp_path, "b.json"),
                            config=cfg)
        assert not r1.wisdom_hit and not r2.wisdom_hit
        assert r1.measurements == r2.measurements > 0
        assert k1 == k2
        assert ([c["knobs"] for c in r1.candidates]
                == [c["knobs"] for c in r2.candidates])

    def test_analytic_measurer_is_deterministic(self, tmp_path):
        cfg = tuner.TuneConfig(measurer="analytic")
        k1, _ = tuner.tune(**KW, wisdom_path=_wisdom(tmp_path, "a.json"),
                           config=cfg)
        k2, _ = tuner.tune(**KW, wisdom_path=_wisdom(tmp_path, "b.json"),
                           config=cfg)
        assert k1 == k2

    def test_default_knobs_are_candidate_zero(self, tmp_path):
        cfg = tuner.TuneConfig(measurer="analytic")
        _, rep = tuner.tune(**KW, wisdom_path=_wisdom(tmp_path),
                            config=cfg)
        assert rep.candidates[0]["knobs"] == {
            "overlap": "off", "layout": "zero_copy"}


class TestWisdomRoundTrip:
    def test_hit_is_pure_lookup(self, tmp_path):
        wp = _wisdom(tmp_path)
        cfg = tuner.TuneConfig(measurer=_fake_measurer())
        k1, r1 = tuner.tune(**KW, wisdom_path=wp, config=cfg)
        assert r1.measurements > 0
        k2, r2 = tuner.tune(**KW, wisdom_path=wp, config=cfg)
        assert r2.wisdom_hit and r2.measurements == 0
        assert k2 == k1
        stats = tuner.tune_stats()
        assert stats["wisdom_hits"] == 1 and stats["tuned"] == 2

    def test_file_survives_reload(self, tmp_path):
        wp = _wisdom(tmp_path)
        cfg = tuner.TuneConfig(measurer="analytic")
        k1, r1 = tuner.tune(**KW, wisdom_path=wp, config=cfg)
        doc = json.loads((tmp_path / "wisdom.json").read_text())
        assert doc["version"] == tuner.WISDOM_VERSION
        assert r1.key in doc["entries"]
        assert doc["entries"][r1.key]["knobs"] == k1
        # a new store object (a new process's) hits
        store = tuner.WisdomStore(wp)
        assert store.lookup(r1.key)["knobs"] == k1

    def test_wisdom_hit_counts_cache_miss_not_hit(self, tmp_path):
        """A wisdom hit that builds a new plan is a plan-cache miss and a
        wisdom hit; only a plan reused from the cache is a cache hit."""
        wp = _wisdom(tmp_path)
        cfg = tuner.TuneConfig(measurer="analytic")
        fft_api.plan(**KW, tune=True, wisdom_path=wp, tune_config=cfg)
        assert fft_api.cache_info()["wisdom_hits"] == 0
        fft_api.clear_plan_cache()  # wisdom outlives the plan cache
        fft_api.plan(**KW, tune=True, wisdom_path=wp, tune_config=cfg)
        info = fft_api.cache_info()
        assert info["wisdom_hits"] == 1
        assert info["hits"] == 0
        assert info["misses"] >= 1
        fft_api.plan(**KW, tune=True, wisdom_path=wp, tune_config=cfg)
        info = fft_api.cache_info()
        assert info["wisdom_hits"] == 2 and info["hits"] == 1


class TestWisdomCorruption:
    @pytest.mark.parametrize("payload", [
        "{not json",                       # truncated or garbage
        '{"version": 99, "entries": {}}',  # wrong version
        '{"version": 1, "entries": 3}',    # wrong entries type
        '["list", "not", "object"]',       # wrong document type
    ])
    def test_corrupt_wisdom_degrades_with_event(self, tmp_path, payload):
        wp = tmp_path / "wisdom.json"
        wp.write_text(payload)
        store = tuner.WisdomStore(str(wp))  # must not raise
        assert len(store) == 0
        evs = events.events("wisdom_corrupt")
        assert evs and evs[-1]["path"] == str(wp)
        # tuning through the corrupt file measures, then repairs it
        cfg = tuner.TuneConfig(measurer="analytic")
        _, rep = tuner.tune(**KW, wisdom_path=str(wp), config=cfg)
        assert not rep.wisdom_hit and rep.measurements > 0
        doc = json.loads(wp.read_text())
        assert doc["version"] == tuner.WISDOM_VERSION

    @pytest.mark.parametrize("stale", [
        {"overlap": 3, "layout": "nope"},  # knobs that no longer resolve
        # an entry written while the port had a batch tile
        {"overlap": "off", "layout": "zero_copy", "batch_tile": 2},
    ])
    def test_stale_invalid_knobs_remeasure(self, tmp_path, stale):
        wp = _wisdom(tmp_path)
        cfg = tuner.TuneConfig(measurer="analytic")
        _, rep = tuner.tune(**KW, wisdom_path=wp, config=cfg)
        store = tuner.WisdomStore.get(wp)
        entry = store.lookup(rep.key)
        entry["knobs"] = stale
        store.record(rep.key, entry)
        knobs, rep2 = tuner.tune(**KW, wisdom_path=wp, config=cfg)
        assert not rep2.wisdom_hit and rep2.measurements > 0
        assert events.events("wisdom_stale")
        # measured again, and rewritten with the two knobs alone
        assert set(knobs) == set(tuner.KNOBS)
        assert store.lookup(rep.key)["knobs"] == knobs


class TestMeshFingerprint:
    def test_different_mesh_shape_remeasures(self, tmp_path, one_rank_group):
        from torch.distributed.device_mesh import init_device_mesh
        wp = _wisdom(tmp_path)
        cfg = tuner.TuneConfig(measurer="analytic")
        mesh_a = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        kw = dict(kind="c2c", shape=(64, 256), batch_shape=(4,),
                  placement="segmented", device="cpu")
        p = fft_api.plan(**kw, mesh=mesh_a, tune=True, wisdom_path=wp,
                         tune_config=cfg)
        assert tuner.tune_stats()["measurements"] > 0
        # the same spec on a mesh of other dims: no hit
        mesh_b = init_device_mesh("cpu", (1, 1),
                                  mesh_dim_names=("data", "model"))
        before = tuner.tune_stats()["measurements"]
        q = fft_api.plan(**kw, mesh=mesh_b, tune=True, wisdom_path=wp,
                         tune_config=cfg)
        assert tuner.tune_stats()["measurements"] > before
        assert fft_api.cache_info()["wisdom_hits"] == 0
        assert tuner.mesh_fingerprint(mesh_a) != \
            tuner.mesh_fingerprint(mesh_b)
        assert p.placement == q.placement == "segmented"

    def test_fingerprint_stable_for_same_mesh(self, one_rank_group):
        from torch.distributed.device_mesh import init_device_mesh
        m1 = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        m2 = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        assert tuner.mesh_fingerprint(m1) == tuner.mesh_fingerprint(m2)
        assert "backend=gloo" in tuner.mesh_fingerprint(m1)
        assert tuner.mesh_fingerprint(None) == "mesh=none"


class TestDegradation:
    def test_unresolvable_spec_degrades(self, tmp_path):
        cfg = tuner.TuneConfig(measurer="analytic")
        knobs, rep = tuner.tune(kind="c2c", shape=(96,), device="cpu",
                                wisdom_path=_wisdom(tmp_path), config=cfg)
        assert knobs == {} and rep.degraded
        assert events.events("tune_degraded")
        # and plan() itself raises the real error
        with pytest.raises(ValueError, match="power of two"):
            fft_api.plan(kind="c2c", shape=(96,), tune=True, device="cpu",
                         wisdom_path=_wisdom(tmp_path), tune_config=cfg)


class TestOutOfCoreTuning:
    def test_round_trip_and_determinism(self, tmp_path):
        wp = _wisdom(tmp_path)
        s1, r1 = tuner.tune_out_of_core(1 << 24, 1 << 22, wisdom_path=wp,
                                        device="cpu")
        assert not r1.wisdom_hit and r1.measurements >= 1
        assert s1 in tuner.OOC_PANEL_SCALES
        s2, r2 = tuner.tune_out_of_core(1 << 24, 1 << 22, wisdom_path=wp,
                                        device="cpu")
        assert r2.wisdom_hit and r2.measurements == 0 and s2 == s1
        s3, _ = tuner.tune_out_of_core(
            1 << 24, 1 << 22, wisdom_path=_wisdom(tmp_path, "b.json"),
            device="cpu")
        assert s3 == s1

    def test_measurer_override_flips_winner(self, tmp_path):
        # a measurer that rewards small panels (more jobs) inverts the
        # disk model's preference: it must win, with the disagreement
        def like_small(factors, cfg):
            return 1.0 / (factors.pass1_jobs + factors.pass2_jobs)
        cfg = tuner.TuneConfig(measurer=like_small)
        s, rep = tuner.tune_out_of_core(
            1 << 24, 1 << 22, wisdom_path=_wisdom(tmp_path), config=cfg,
            device="cpu")
        assert s == max(c["knobs"]["panel_scale"] for c in rep.candidates)
        if len(rep.candidates) > 1:
            assert rep.disagreement
            assert events.events("tune_disagreement")


class TestServiceWarmup:
    def test_first_request_zero_plan_misses(self):
        from repro_torch.serve import FftService
        svc = FftService(coalesce=4, device="cpu")
        summary = svc.warmup([
            {"kind": "c2c", "shape": (64,), "rows": 2},
            ("r2c", (64,), 2),
        ])
        assert summary["specs"] == 2
        before = fft_api.cache_info()["misses"]
        with svc:
            t1 = svc.submit("c2c", np.ones((2, 64), np.float32),
                            np.zeros((2, 64), np.float32))
            t2 = svc.submit("r2c", np.ones((2, 64), np.float32))
            t1.result(timeout=60)
            t2.result(timeout=60)
        assert fft_api.cache_info()["misses"] == before
        want = np.fft.fft(np.ones((2, 64)))
        got_r, _ = t1.result()
        np.testing.assert_allclose(np.asarray(got_r), want.real, atol=1e-3)

    def test_warmup_with_abft_covers_checksum_row(self):
        from repro_torch.serve import FftService
        svc = FftService(coalesce=2, verify="abft", impl="ref", device="cpu")
        svc.warmup([{"kind": "c2c", "shape": (64,), "rows": 2}])
        before = fft_api.cache_info()["misses"]
        with svc:
            t = svc.submit("c2c", np.ones((2, 64), np.float32),
                           np.zeros((2, 64), np.float32))
            t.result(timeout=60)
        assert fft_api.cache_info()["misses"] == before


# ------------------------------------------- benchmarks/bench_tune.py gates

TUNE_SPECS = {
    "c2c_leaf": dict(kind="c2c", n=1024, batch_shape=(64,)),
    "c2c_level1": dict(kind="c2c", n=1 << 16, batch_shape=(4,)),
    "r2c_leaf": dict(kind="r2c", n=4096, batch_shape=(16,)),
    "c2c_2d": dict(kind="c2c", shape=(64, 256), batch_shape=(2,)),
    "stockham": dict(kind="c2c", n=1024, batch_shape=(64,),
                     impl="stockham"),
}


@pytest.mark.parametrize("name", sorted(TUNE_SPECS))
def test_tuned_le_default_on_the_analytic_model(tmp_path, name):
    """bench_tune's first gate: the winner is no slower than the default,
    candidate 0, under the same measurer."""
    cfg = tuner.TuneConfig(measurer="analytic")
    knobs, rep = tuner.tune(**TUNE_SPECS[name], device="cpu",
                            wisdom_path=_wisdom(tmp_path), config=cfg)
    default = rep.candidates[0]["measured_s"]
    assert min(c["measured_s"] for c in rep.candidates) <= default
    assert knobs == min(rep.candidates,
                        key=lambda c: c["measured_s"])["knobs"]


def test_ooc_tuned_le_default_on_the_disk_model(tmp_path):
    scale, rep = tuner.tune_out_of_core(1 << 24, 1 << 22, device="cpu",
                                        wisdom_path=_wisdom(tmp_path))
    default = next(c["measured_s"] for c in rep.candidates
                   if c["knobs"]["panel_scale"] == 1)
    assert min(c["measured_s"] for c in rep.candidates) <= default
    assert scale in tuner.OOC_PANEL_SCALES


_CHILD = r"""
import json, sys
import repro_torch.fft as fft_api
from repro_torch.fft import tuner

wp, payload = sys.argv[1], json.loads(sys.argv[2])
cfg = tuner.TuneConfig(measurer="analytic")
p = fft_api.plan(kind="c2c", shape=tuple(payload["shape"]),
                 batch_shape=tuple(payload["batch_shape"]), device="cpu",
                 tune=True, wisdom_path=wp, tune_config=cfg)
stats = tuner.tune_stats()
print(json.dumps({
    "measurements": stats["measurements"],
    "wisdom_hits": stats["wisdom_hits"],
    "knobs": {"layout": p.spec.layout, "overlap": p.spec.overlap},
    "cache_wisdom_hits": fft_api.cache_info()["wisdom_hits"],
}))
"""


def test_wisdom_round_trip_across_processes(tmp_path):
    """bench_tune's second gate: a second process planning the same spec
    against the file measures nothing and gets the same knobs."""
    wp = _wisdom(tmp_path)
    payload = json.dumps({"shape": [64, 256], "batch_shape": [8]})
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    outs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _CHILD, wp, payload],
                              capture_output=True, text=True, env=env,
                              check=True, timeout=240)
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first, second = outs
    assert first["measurements"] > 0 and first["wisdom_hits"] == 0
    assert second["measurements"] == 0
    assert second["wisdom_hits"] == 1 and second["cache_wisdom_hits"] == 1
    assert second["knobs"] == first["knobs"]


# ------------------------------------------- parity with the reference


def test_tuned_plan_matches_the_reference_and_the_default(tmp_path, rng):
    """The port's tuned plan within 5e-6 of the reference's tuned plan on
    the same seeded input, and bitwise equal to the port's default plan;
    on a level-1 spec, with a fake measurer that prefers the copy layout,
    so the port's winner has a non-default layout."""
    import repro.fft as jfft
    from repro.fft import tuner as jtuner

    def likes_copy(plan, cfg):
        return 1e-3 * (0.5 if plan.spec.layout == "copy" else 1.0)

    kw = dict(kind="c2c", n=1 << 13, batch_shape=(4,), device="cpu")
    x = rng.standard_normal((2, 4, 1 << 13)).astype(np.float32)
    p = fft_api.plan(**kw, tune=True, wisdom_path=_wisdom(tmp_path),
                     tune_config=tuner.TuneConfig(measurer=likes_copy))
    assert p.spec.layout == "copy"
    got = p.execute(*map(torch.from_numpy, x))
    default = fft_api.plan(**kw)
    assert default.spec.layout == "zero_copy"
    want0 = default.execute(*map(torch.from_numpy, x))
    assert all(torch.equal(a, b) for a, b in zip(got, want0))
    jfft.clear_plan_cache()
    jp = jfft.plan(kind="c2c", n=1 << 13, batch_shape=(4,), tune=True,
                   wisdom_path=_wisdom(tmp_path, "ref.json"),
                   tune_config=jtuner.TuneConfig(measurer="analytic"))
    want = [np.asarray(a) for a in jp.execute(*map(jnp.asarray, x))]
    g = got[0].double().numpy() + 1j * got[1].double().numpy()
    w = want[0].astype(np.float64) + 1j * want[1]
    assert np.abs(g - w).max() / np.abs(w).max() < TOL


def test_model_rates_by_device():
    """The CPU keeps the JAX package's constants; CUDA has its own."""
    from repro.fft import tuner as jtuner
    cfg = tuner.TuneConfig()
    assert cfg.rates("cpu") == {
        "peak_flops": jtuner.PEAK_FLOPS, "hbm_bps": jtuner.HBM_BPS,
        "ici_bps": jtuner.ICI_BPS, "disk_bps": jtuner.DISK_BPS,
        "job_overhead_s": jtuner.JOB_OVERHEAD_S}
    assert cfg.rates("cuda") == tuner.MODEL_RATES["cuda"]
    assert tuner.TuneConfig(hbm_bps=1.0).rates("cuda")["hbm_bps"] == 1.0


# ----------------------------------- the CUDA shape and the candidates


@pytest.mark.parametrize("kw,shape,batch", [
    # the block job's spec: 8 waves on 132 SMs need 16896 rows, so 32768
    (dict(kind="c2c", n=1024, batch_shape=(32768,)), (1024,), (32768,)),
    (dict(kind="c2c", n=1024, batch_shape=(1 << 17,)), (1024,), (32768,)),
    # the service's paper mix: every row
    (dict(kind="c2c", n=1024, batch_shape=(256,)), (1024,), (256,)),
    (dict(kind="c2c", n=1 << 16, batch_shape=(16,)), (1 << 16,), (16,)),
    (dict(kind="r2c", n=4096, batch_shape=(256,)), (4096,), (256,)),
    # fft2 over 8 images of 4096^2: 2 images
    (dict(kind="c2c", shape=(4096, 4096), batch_shape=(8,)), (4096, 4096),
     (2,)),
    (dict(kind="c2c", n=1024, batch_shape=(64,), impl="ref"), (1024,),
     (64,)),
])
def test_cuda_measurement_shape_and_tiles(kw, shape, batch):
    base = tspec.resolve(**kw, device="cpu")
    assert tuner._cuda_shape(base, None, 132) == (shape, batch)


def test_cuda_measurement_keeps_segmented_rows_per_rank():
    base = tspec.resolve(kind="c2c", n=1024, batch_shape=(1 << 17,),
                         placement="segmented", num_devices=4,
                         axes=("data",), device="cpu")
    assert tuner._cuda_shape(base, 4, 132) == ((1024,), (4 * 32768,))


def test_distributed_1d_takes_no_tile_and_every_overlap(tmp_path):
    base = tspec.resolve(kind="c2c", n=1 << 24, placement="distributed",
                         num_devices=1, axes=("data",), device="cpu")
    cands = tuner._candidates(base)
    assert all(set(c) == set(tuner.KNOBS) for c in cands)
    assert [c["overlap"] for c in cands if c["layout"] == "copy"] == \
        ["off", 2, 4, 8]


@pytest.mark.parametrize("kw,layouts", [
    # level 0, 1-D: the same K1 or K3 launch at either layout
    (dict(kind="c2c", n=1024, batch_shape=(64,)), ["zero_copy"]),
    (dict(kind="r2c", n=4096, batch_shape=(16,)), ["zero_copy"]),
    # a pass through axis_pass or the four-step: both layouts
    (dict(kind="c2c", n=1 << 16, batch_shape=(4,)), ["zero_copy", "copy"]),
    (dict(kind="r2c", n=1 << 14, batch_shape=(4,)), ["zero_copy", "copy"]),
    (dict(kind="c2c", shape=(64, 256), batch_shape=(2,)),
     ["zero_copy", "copy"]),
    (dict(kind="c2c", n=1 << 24, placement="distributed", num_devices=1,
          axes=("data",)), ["zero_copy", "copy"]),
])
def test_copy_is_a_candidate_only_where_a_pass_reads_the_layout(kw,
                                                                 layouts):
    base = tspec.resolve(**kw, impl="matfft", device="cpu")
    got = []
    for c in tuner._candidates(base):
        if c["layout"] not in got:
            got.append(c["layout"])
    assert got == layouts


# ------------------------------------------------- the facade selftest


def test_selftest_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.fft.selftest", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("selftest ") and "plan cache" not in ln]
    assert len(lines) >= 17 and all(" OK " in ln for ln in lines)
