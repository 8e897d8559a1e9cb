"""The port's spectral ops (`repro_torch.core.spectral`) against numpy and
the JAX package's, the spectrogram map-only job of
examples/spectral_analysis.py, and `fft_job --impl stockham`; on the CPU
through the kernels' plain versions.
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import spectral as jspectral
from repro.core.pipeline import BlockStore as JBlockStore
from repro.core.pipeline import JobConfig as JJobConfig
from repro.launch import fft_job as jjob
from repro_torch.core import spectral
from repro_torch.core.pipeline import (BlockStore, JobConfig, MapOnlyJob,
                                       segments_of_block)
from repro_torch.kernels.fft import matfft as km
from repro_torch.kernels.fft import stockham as ks
from repro_torch.launch import fft_job

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

TOL = 5e-6       # max|port - ref| / max|ref| (fft/selftest.py)
TOL_CONV = 1e-4  # tests/test_spectral.py's bar against np.convolve
ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


# ---------------------------------------------------------------------------
# tests/test_spectral.py, mirrored on the port


@settings(max_examples=10, deadline=None)
@given(t=st.sampled_from([128, 500, 1024]), tk=st.sampled_from([3, 17, 64]),
       seed=st.integers(0, 50))
def test_fft_conv_matches_numpy(t, tk, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal(t).astype(np.float32)
    k = r.standard_normal(tk).astype(np.float32)
    got = spectral.fft_conv(x, k, device="cpu").numpy()
    assert _rel(got, np.convolve(x, k)[:t]) < TOL_CONV


def test_fft_conv_batched(rng):
    x = rng.standard_normal((3, 256)).astype(np.float32)
    k = rng.standard_normal(16).astype(np.float32)
    got = spectral.fft_conv(torch.from_numpy(x), torch.from_numpy(k),
                            device="cpu").numpy()
    for i in range(3):
        assert _rel(got[i], np.convolve(x[i], k)[:256]) < TOL_CONV


def test_stft_shapes_and_tone():
    n, frame, hop, bin_idx = 4096, 256, 128, 32
    t = np.arange(n)
    x = np.cos(2 * np.pi * bin_idx * t / frame).astype(np.float32)
    ps = spectral.power_spectrogram(x, frame, hop, device="cpu").numpy()
    assert ps.shape == (1 + (n - frame) // hop, frame // 2 + 1)
    assert (ps.argmax(axis=-1) == bin_idx).mean() > 0.9


def test_spectral_mixer_matches_fnet_reference(rng):
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    got = spectral.spectral_mixer(x, device="cpu").numpy()
    want = np.fft.fft(np.fft.fft(x, axis=-1), axis=-2).real
    assert _rel(got, want) < TOL_CONV


def test_frame_signal_strides(rng):
    x = rng.standard_normal(100).astype(np.float32)
    frames = spectral.frame_signal(x, 16, 8, device="cpu").numpy()
    assert frames.shape == (11, 16)
    np.testing.assert_array_equal(frames[1], x[8:24])


# ---------------------------------------------------------------------------
# against the JAX package's spectral functions


@pytest.mark.parametrize("frame,hop,window", [(512, 256, True),
                                              (1024, 512, True),
                                              (64, 16, False)])
def test_stft_matches_reference(rng, frame, hop, window):
    x = rng.standard_normal((2, 6000)).astype(np.float32)
    km.reset_counts()
    got = spectral.stft(x, frame, hop, window=window, device="cpu")
    assert km.rfft_leaf_plain.calls == 1
    want = jspectral.stft(jnp.asarray(x), frame, hop, window=window)
    assert tuple(got[0].shape) == tuple(want[0].shape)
    g = got[0].numpy() + 1j * got[1].numpy()
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    assert _rel(g, w) < TOL
    frames = spectral.frame_signal(x, frame, hop, device="cpu").numpy()
    np.testing.assert_array_equal(
        frames, np.asarray(jspectral.frame_signal(jnp.asarray(x), frame, hop)))


@pytest.mark.parametrize("t,tk", [(300, 17), (4000, 100)])
def test_fft_conv_matches_reference(rng, t, tk):
    x = rng.standard_normal((2, t)).astype(np.float32)
    k = rng.standard_normal(tk).astype(np.float32)
    got = spectral.fft_conv(x, k, device="cpu").numpy()
    want = np.asarray(jspectral.fft_conv(jnp.asarray(x), jnp.asarray(k)))
    assert _rel(got, want) < TOL_CONV
    assert _rel(got, [np.convolve(row, k)[:t] for row in x]) < TOL_CONV


def test_spectral_mixer_matches_reference(rng):
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    got = spectral.spectral_mixer(x, device="cpu").numpy()
    want = np.asarray(jspectral.spectral_mixer(jnp.asarray(x)))
    assert _rel(got, want) < TOL


def test_fft_conv2d_waits_for_the_nd_plans(rng):
    """It waited for the N-D r2c plans; on them it matches the
    reference's fft_conv2d and a direct convolution."""
    x = rng.standard_normal((2, 16, 20)).astype(np.float32)
    k = rng.standard_normal((3, 5)).astype(np.float32)
    got = spectral.fft_conv2d(x, k, device="cpu").numpy()
    want = np.asarray(jspectral.fft_conv2d(jnp.asarray(x), jnp.asarray(k)))
    assert got.shape == x.shape
    assert _rel(got, want) < TOL
    direct = np.zeros(x.shape, np.float64)
    for i in range(3):
        for j in range(5):
            direct[:, i:, j:] += k[i, j] * x[:, :16 - i, :20 - j]
    assert _rel(got, direct) < TOL


def test_spectral_ops_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spectral.stft(np.zeros(2048, np.float32))


# ---------------------------------------------------------------------------
# the spectrogram job of examples/spectral_analysis.py


def _example():
    spec = importlib.util.spec_from_file_location(
        "spectral_analysis_example", ROOT / "examples" / "spectral_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spectrogram_job_matches_the_reference_example(tmp_path):
    """The example's steps 2-3 at 2 s of capture in 1 s blocks: the port's
    job, whose map task is the port's power_spectrogram on the CPU, against
    the example's map function (the reference's power_spectrogram) block
    for block. Squaring the magnitude roughly doubles the relative error,
    hence 1e-5 of each block's maximum."""
    ex = _example()
    x = ex.synth_capture(seconds=2.0)
    store = BlockStore(tmp_path / "in", block_bytes=4 * ex.SR)
    store.put_bytes(x.tobytes())

    def map_fn(data, idx):
        samples = np.frombuffer(data, np.float32).copy()
        ps = spectral.power_spectrogram(samples, ex.FRAME, ex.HOP,
                                        device="cpu")
        return ps.numpy().tobytes()

    km.reset_counts()
    job = MapOnlyJob(store, tmp_path / "out", map_fn, JobConfig(workers=2))
    assert job.run().blocks_done == 2
    assert km.rfft_leaf_plain.calls >= 2
    job.merge(tmp_path / "spectrogram.bin")
    n_bins = ex.FRAME // 2 + 1
    merged = np.fromfile(tmp_path / "spectrogram.bin",
                         np.float32).reshape(2, -1, n_bins)
    for i in range(2):
        samples = np.frombuffer(store.read_block(i), np.float32)
        want = np.asarray(jspectral.power_spectrogram(
            jnp.asarray(samples), ex.FRAME, ex.HOP), np.float32)
        assert merged[i].shape == want.shape
        assert _rel(merged[i], want) < 1e-5
    found = np.sort(np.argsort(merged.reshape(-1, n_bins).mean(axis=0))[-3:])
    for f, hz in zip(found * ex.SR / ex.FRAME, sorted(ex.TONES_HZ)):
        assert abs(f - hz) < ex.SR / ex.FRAME + 1


# ---------------------------------------------------------------------------
# fft_job --impl stockham


def test_fft_job_stockham_serial_and_pipelined(tmp_path, rng):
    """A store written by the reference through the port's job with K4
    leaves (plain versions here): serial and pipelined outputs bitwise
    equal, and within the tolerance of the reference's stockham job."""
    fft_len, segs = 256, 4
    sig = rng.standard_normal((3 * segs, fft_len, 2)).astype(np.float32)
    jstore = JBlockStore(tmp_path / "in", block_bytes=8 * fft_len * segs)
    jstore.put_bytes(sig.tobytes())
    jjob.run_job(jstore, tmp_path / "ref", fft_len=fft_len, impl="stockham",
                 cfg=JJobConfig(workers=2), pipelined=True)
    store = BlockStore.open(tmp_path / "in")
    for mode, pipelined in (("serial", False), ("pipelined", True)):
        ks.reset_counts()
        job, stats, _ = fft_job.run_job(
            store, tmp_path / mode, fft_len=fft_len, impl="stockham",
            cfg=JobConfig(workers=2, coalesce=3), pipelined=pipelined,
            device="cpu")
        assert stats.blocks_done == 3
        assert ks.stockham_fft_plain.calls > 0 and km.matfft_plain.calls == 0
        job.merge(tmp_path / f"{mode}.bin")
    assert ((tmp_path / "serial.bin").read_bytes()
            == (tmp_path / "pipelined.bin").read_bytes())
    for b in store.blocks:
        gr, gi = segments_of_block((tmp_path / "serial" / b.name())
                                   .read_bytes(), fft_len)
        wr, wi = segments_of_block((tmp_path / "ref" / b.name())
                                   .read_bytes(), fft_len)
        assert _rel(gr + 1j * gi, wr + 1j * wi) < TOL
