"""The port's map-only FFT job end to end on the CPU, against the JAX
package's, plus the port's isolation and device rules.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.pipeline import BlockStore as JBlockStore
from repro.core.pipeline import JobConfig as JJobConfig
from repro.launch import fft_job as jjob
from repro_torch.core.pipeline import BlockStore, JobConfig, segments_of_block
from repro_torch.kernels.fft import matfft as km
from repro_torch.launch import fft_job

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)
ROOT = Path(__file__).resolve().parents[1]


def _store(tmp_path, rng, fft_len, segs_per_block, blocks):
    """A store written by the JAX package: the shared on-disk format."""
    sig = rng.standard_normal((blocks * segs_per_block, fft_len, 2))
    store = JBlockStore(tmp_path / "in",
                        block_bytes=8 * fft_len * segs_per_block)
    store.put_bytes(sig.astype(np.float32).tobytes())
    return store


def _blocks(out_dir, store, fft_len):
    return [segments_of_block((Path(out_dir) / b.name()).read_bytes(),
                              fft_len) for b in store.blocks]


@pytest.mark.parametrize("fft_len", [256, 8192])
def test_port_job_matches_reference_job_block_by_block(tmp_path, rng,
                                                       fft_len):
    jstore = _store(tmp_path, rng, fft_len, segs_per_block=4, blocks=3)
    jjob.run_job(jstore, tmp_path / "ref", fft_len=fft_len, impl="matfft",
                 cfg=JJobConfig(workers=2), pipelined=True)
    store = BlockStore.open(tmp_path / "in")  # the reference's store
    km.reset_counts()
    fft_job.run_job(store, tmp_path / "port", fft_len=fft_len,
                    impl="matfft", cfg=JobConfig(coalesce=2),
                    pipelined=True, device="cpu")
    assert km.matfft_plain.calls + km.matfft_cols_plain.calls > 0
    got = _blocks(tmp_path / "port", store, fft_len)
    want = _blocks(tmp_path / "ref", store, fft_len)
    assert len(got) == len(want) == 3
    for (gr, gi), (wr, wi) in zip(got, want):
        g, w = gr + 1j * gi, wr + 1j * wi
        assert np.abs(g - w).max() / np.abs(w).max() < TOL


@pytest.mark.parametrize("fft_len,verify", [(1024, "off"), (1024, "abft"),
                                            (16384, "parseval")])
def test_port_pipelined_equals_serial_bitwise(tmp_path, rng, fft_len,
                                              verify):
    _store(tmp_path, rng, fft_len, segs_per_block=4, blocks=4)
    store = BlockStore.open(tmp_path / "in")
    for mode, pipelined in (("serial", False), ("pipelined", True)):
        job, stats, stage_s = fft_job.run_job(
            store, tmp_path / mode, fft_len=fft_len, impl="matfft",
            cfg=JobConfig(workers=2, coalesce=4), pipelined=pipelined,
            verify=verify, device="cpu")
        assert stats.blocks_done == 4 and set(stage_s) == set(fft_job.STAGES)
        job.merge(tmp_path / f"{mode}.bin")
    assert ((tmp_path / "serial.bin").read_bytes()
            == (tmp_path / "pipelined.bin").read_bytes())


def test_fft_job_cli_on_cpu_with_faults(tmp_path):
    report = fft_job.main([
        "--device", "cpu", "--size-mb", "1", "--fft-len", "1024",
        "--segments-per-block", "32", "--pipelined", "--coalesce", "2",
        "--work-dir", str(tmp_path), "--faults",
        "seed=3,rate=0.3,sites=stream.decode+stream.realize"])
    assert report["blocks"] == 4 and report["failed_blocks"] == []
    assert report["device"] == "cpu"
    assert report["plan_cache"]["entries"] >= 1
    merged = (tmp_path / "merged.bin").read_bytes()
    store = BlockStore.open(tmp_path / "in")
    x = np.concatenate([np.frombuffer(store.read_block(i), np.float32)
                        for i in range(len(store.blocks))])
    x = x.reshape(-1, 1024, 2)
    y = np.frombuffer(merged, np.float32).reshape(-1, 1024, 2)
    want = np.fft.fft(x[..., 0].astype(np.float64) + 1j * x[..., 1])
    got = y[..., 0] + 1j * y[..., 1]
    assert np.abs(got - want).max() / np.abs(want).max() < TOL


def test_fft_job_without_device_cpu_raises_on_a_host_without_a_card(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fft_job.main(["--size-mb", "1", "--work-dir", str(tmp_path)])
    assert not (tmp_path / "in").exists()  # failed before any work


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, repro_torch.launch.fft_job, chip_smoke\n"
        "import repro_torch.serve, repro_torch.launch.fft_serve\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "assert {'repro_torch.core.fft.outofcore',\n"
        "        'repro_torch.core.fft.segmented',\n"
        "        'repro_torch.core.fft.distributed',\n"
        "        'repro_torch.core.resilience.meshstate',\n"
        "        'repro_torch.serve.fft_service',\n"
        "        'repro_torch.serve.loadgen',\n"
        "        'repro_torch.launch.fft_serve',\n"
        "        'repro_torch.configs.gemma3_1b',\n"
        "        'repro_torch.models.config',\n"
        "        'repro_torch.models.scanning',\n"
        "        'repro_torch.models.common',\n"
        "        'repro_torch.models.mlp',\n"
        "        'repro_torch.models.attention',\n"
        "        'repro_torch.models.linear_attn',\n"
        "        'repro_torch.models.rwkv6',\n"
        "        'repro_torch.models.mamba2',\n"
        "        'repro_torch.models.moe',\n"
        "        'repro_torch.models.transformer',\n"
        "        'repro_torch.models.convert',\n"
        "        'repro_torch.models.conditioning',\n"
        "        'repro_torch.sharding.rules',\n"
        "        'repro_torch.serve.engine',\n"
        "        'repro_torch.launch.serve',\n"
        "        'repro_torch.launch.mesh',\n"
        "        'repro_torch.tree',\n"
        "        'repro_torch.optim',\n"
        "        'repro_torch.optim.optimizers',\n"
        "        'repro_torch.optim.schedules',\n"
        "        'repro_torch.optim.compression',\n"
        "        'repro_torch.checkpoint',\n"
        "        'repro_torch.checkpoint.manager',\n"
        "        'repro_torch.data',\n"
        "        'repro_torch.data.pipeline',\n"
        "        'repro_torch.train',\n"
        "        'repro_torch.train.trainer',\n"
        "        'repro_torch.launch.train',\n"
        "        'repro_torch.launch.specs',\n"
        "        'repro_torch.launch.dryrun',\n"
        "        'repro_torch.launch.sweep'} <= set(sys.modules)\n"
        "print('clean')\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the package beside it, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_rehearsal_passes_on_the_cpu():
    """The smoke script's phases at tiny sizes through the plain versions:
    the control flow a run on the card takes, checked here."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--rehearse"], cwd=ROOT, capture_output=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "rehearsal passed" in out.stdout
    assert '"ok"' not in out.stdout
