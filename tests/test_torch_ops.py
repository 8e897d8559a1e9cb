"""The port's deprecated per-call shims (`repro_torch.kernels.fft.ops`)
against the JAX package's (`repro.kernels.fft.ops`), on cases of
tests/test_kernels_fft.py, tests/test_zero_copy_rfft.py and
tests/test_fft_plan_api.py. On the CPU the port runs its kernels' plain
PyTorch versions; the reference runs Pallas in interpret mode."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fft as fft_api
from repro.kernels.fft import ops as jops
from repro_torch.fft import executors
from repro_torch.kernels.fft import ops

TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)

torch.set_num_threads(1)


def _rel_err(got, want) -> float:
    g = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1])
    w = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1])
    return float(np.abs(g - w).max() / np.abs(w).max())


def _planes(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("impl", ["matfft", "stockham"])
@pytest.mark.parametrize("n", [2, 256, 4096])
@pytest.mark.parametrize("rows", [1, 3])
def test_fft_shim_matches_the_reference(impl, n, rows):
    xr, xi = _planes(n + rows, rows, n)
    got = ops.fft(torch.from_numpy(xr), torch.from_numpy(xi), impl=impl)
    want = jops.fft(jnp.asarray(xr), jnp.asarray(xi), impl=impl)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in got)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("layout", ["zero_copy", "copy"])
def test_level1_fft_and_ifft_shims(layout):
    xr, xi = _planes(1, 2, 32768)
    got = ops.fft(torch.from_numpy(xr), torch.from_numpy(xi), layout=layout)
    want = jops.fft(jnp.asarray(xr), jnp.asarray(xi), layout=layout)
    assert _rel_err(got, want) < TOL
    back = ops.ifft(*got, layout=layout)
    assert _rel_err(back, (xr, xi)) < 1e-5


def test_fft_cols_shim_is_the_transposed_fft():
    xr, xi = _planes(2, 256, 16)
    got = ops.fft_cols(torch.from_numpy(xr), torch.from_numpy(xi))
    want = jops.fft_cols(jnp.asarray(xr), jnp.asarray(xi))
    assert tuple(got[0].shape) == (16, 256)
    assert _rel_err(got, want) < TOL
    rows = ops.fft(torch.from_numpy(xr.T.copy()),
                   torch.from_numpy(xi.T.copy()))
    assert all(torch.equal(a, b) for a, b in zip(got, rows))


@pytest.mark.parametrize("n", [8, 1024, 16384])
def test_rfft_and_irfft_shims(n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    got = ops.rfft(torch.from_numpy(x))
    want = jops.rfft(jnp.asarray(x))
    assert tuple(got[0].shape) == (3, n // 2 + 1)
    assert _rel_err(got, want) < TOL
    back = ops.irfft(*got)
    assert float((back - torch.from_numpy(x)).abs().max()) < 1e-5 * float(
        np.abs(x).max())


def test_complex64_shims_round_trip():
    xr, xi = _planes(3, 2, 512)
    z = torch.complex(torch.from_numpy(xr), torch.from_numpy(xi))
    y = ops.fft_c64(z)
    want = jops.fft_c64(jnp.asarray(xr + 1j * xi))
    assert y.dtype == torch.complex64
    assert _rel_err((y.real, y.imag), (np.real(want), np.imag(want))) < TOL
    back = ops.ifft_c64(y)
    assert float((back - z).abs().max()) < 1e-5 * float(z.abs().max())


def test_degenerate_rfft_of_one_sample():
    yr, yi = ops.rfft(torch.ones((2, 1)))
    assert tuple(yr.shape) == (2, 1) and float(yi.abs().max()) == 0.0
    assert torch.equal(yr, torch.ones((2, 1)))


def test_each_shim_warns_once_and_reuses_the_plan():
    ops._reset_deprecation_warnings()
    xr, xi = (torch.from_numpy(a) for a in _planes(4, 2, 64))
    fft_api.clear_plan_cache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            ops.fft(xr, xi)
            ops.ifft(xr, xi)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 2 and all("repro_torch.fft.plan" in m for m in msgs)
    info = fft_api.cache_info()
    assert info["entries"] == 1 and info["hits"] == 5


def test_global_twiddle_path_delegates_without_warning():
    ops._reset_deprecation_warnings()
    xr, xi = (torch.from_numpy(a) for a in _planes(5, 4, 256))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = ops.fft(xr, xi, global_twiddle=(1024, 4))
    want = executors.fft(xr, xi, global_twiddle=(1024, 4))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fft_jit_is_fft():
    assert ops.fft_jit is ops.fft
