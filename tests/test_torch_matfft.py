"""The port's leaf kernels K1 (`matfft`) and K2 (`matfft_cols`).

On the CPU the wrappers run the plain PyTorch versions; those are held to
the JAX package's Pallas kernels in interpret mode. The CUDA kernels
themselves are held to the plain versions in test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.fft.matfft import matfft as jmatfft
from repro.kernels.fft.matfft import matfft_cols as jmatfft_cols
from repro_torch.kernels.fft import matfft as km

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)


def _rel_err(got, want) -> float:
    g = np.asarray(got[0]) + 1j * np.asarray(got[1])
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    return float(np.abs(g - w).max() / (np.abs(w).max() or 1.0))


def _planes(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("n", [2, 16, 256, 512, 4096])
@pytest.mark.parametrize("rows", [1, 5])
def test_k1_plain_matches_pallas(rng, n, rows):
    x = _planes(rng, (rows, n))
    got = km.matfft(*_t(x))
    want = jmatfft(*_j(x), interpret=True)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("n", [16, 256, 1024])
def test_k1_plain_periodic_epilogue_matches_pallas(rng, n):
    rows, period = 24, 8  # rows ragged against the kernel's row tile
    x = _planes(rng, (rows, n))
    epi = _planes(rng, (period, n))
    got = km.matfft(*_t(x), epilogue=_t(epi))
    want = jmatfft(*_j(x), epilogue=_j(epi), batch_tile=8, interpret=True)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("L,C", [(16, 8), (256, 4), (512, 2)])
@pytest.mark.parametrize("out_major", ["row", "col"])
@pytest.mark.parametrize("with_epilogue", [False, True])
def test_k2_plain_matches_pallas(rng, L, C, out_major, with_epilogue):
    B = 3
    x = _planes(rng, (B, L, C))
    epi = _planes(rng, (C, L)) if with_epilogue else None
    got = km.matfft_cols(*_t(x), out_major=out_major,
                         epilogue=_t(epi) if epi else None)
    want = jmatfft_cols(*_j(x), out_major=out_major,
                        epilogue=_j(epi) if epi else None, interpret=True)
    assert tuple(got[0].shape) == tuple(want[0].shape)
    assert _rel_err(got, want) < TOL


def test_cpu_tensors_take_the_plain_version(rng):
    km.reset_counts()
    x = _t(_planes(rng, (4, 64)))
    km.matfft(*x)
    km.matfft_cols(x[0].reshape(1, 64, 4), x[1].reshape(1, 64, 4))
    assert (km.matfft.launches, km.matfft_cols.launches) == (0, 0)
    assert (km.matfft_plain.calls, km.matfft_cols_plain.calls) == (1, 1)


def test_plain_rows_are_independent_of_the_batch(rng):
    x = _t(_planes(rng, (16, 1024)))
    alone = km.matfft(x[0][3:4], x[1][3:4])
    batch = km.matfft(*x)
    assert _rel_err((alone[0][0], alone[1][0]),
                    (batch[0][3], batch[1][3])) < TOL


@pytest.mark.parametrize("call,match", [
    (lambda x: km.matfft(*x, global_twiddle=(1024, 0)), "item 7"),
    (lambda x: km.matfft_cols(x[0].reshape(1, 16, 4), x[1].reshape(1, 16, 4),
                              col_offset=2, ncols=2), "item 7"),
])
def test_distributed_options_are_not_in_this_slice(rng, call, match):
    with pytest.raises(NotImplementedError, match=match):
        call(_t(_planes(rng, (4, 16))))


@pytest.mark.parametrize("bad,exc", [
    (lambda x: km.matfft(x[0], x[1][:2]), ValueError),
    (lambda x: km.matfft(x[0].double(), x[1].double()), TypeError),
    (lambda x: km.matfft(*x, epilogue=(x[0][:3], x[1][:3])), ValueError),
    (lambda x: km.matfft(torch.zeros(2, 3 * 4096), torch.zeros(2, 3 * 4096)),
     ValueError),
    (lambda x: km.matfft(x[0].to("meta"), x[1].to("meta")), ValueError),
])
def test_wrappers_reject_what_the_kernel_does_not_take(rng, bad, exc):
    with pytest.raises(exc):
        bad(_t(_planes(rng, (4, 16))))
