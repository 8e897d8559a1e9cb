"""The port's leaf kernels K1 (`matfft`) and K2 (`matfft_cols`), with the
distributed four-step's options: the global twiddle and K2's column slab.

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


# every leaf length: two register passes up to 256, three from 512 on
TWO_PASS_NS = [1 << p for p in range(9)]
THREE_PASS_NS = [512, 1024, 2048, 4096]


@pytest.mark.parametrize("n", TWO_PASS_NS + THREE_PASS_NS)
@pytest.mark.parametrize("rows", [1, 5])
def test_k1_plain_matches_pallas(rng, n, rows):
    x = _planes(rng, (rows, n))
    got = km.matfft(*_t(x))
    want = jmatfft(*_j(x), interpret=True)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("n", TWO_PASS_NS + [1024, 2048])
def test_k1_plain_periodic_epilogue_matches_pallas(rng, n):
    rows, period = 24, 8  # rows ragged against the kernel's row tile
    x = _planes(rng, (rows, n))
    epi = _planes(rng, (period, n))
    got = km.matfft(*_t(x), epilogue=_t(epi))
    want = jmatfft(*_j(x), epilogue=_j(epi), batch_tile=8, interpret=True)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("L,C", [(2, 8), (4, 8), (8, 8), (16, 8), (32, 4),
                                 (64, 4), (128, 2), (256, 4), (512, 2),
                                 (1024, 2)])
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


@pytest.mark.parametrize("n", THREE_PASS_NS)
def test_three_pass_plain_matches_numpy(rng, n):
    """The three-pass radix FFT against numpy's float64 FFT."""
    x = _planes(rng, (3, n))
    got = km._radix_plain(*_t(x), km.leaf_tables(n, torch.device("cpu")))
    want = np.fft.fft(x[0].astype(np.float64) + 1j * x[1], axis=-1)
    assert _rel_err(got, (want.real, want.imag)) < TOL


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


# the distributed four-step's options: the global-twiddle epilogue (K1, K2)
# and K2's column slab, against the Pallas kernels' own


@pytest.mark.parametrize("n,rows,n_global,row_off", [
    (2, 8, 64, 0), (16, 8, 1 << 10, 0), (64, 16, 1 << 12, 3),
    (256, 24, 1 << 20, 40), (512, 8, 1 << 18, 8), (1024, 8, 1 << 16, 8),
    (4096, 8, 1 << 24, 4096), (256, 8, 1 << 32, (1 << 24) - 8)])
def test_k1_plain_global_twiddle_matches_pallas(rng, n, rows, n_global,
                                                row_off):
    x = _planes(rng, (rows, n))
    got = km.matfft(*_t(x), global_twiddle=(n_global, row_off))
    want = jmatfft(*_j(x), global_twiddle=(n_global, jnp.asarray(row_off)),
                   batch_tile=8, interpret=True)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("L,C,col_offset,ncols", [
    (16, 8, 4, 2), (64, 8, 0, 8), (256, 4, 2, 2), (512, 4, 3, 1),
    (1024, 2, 1, 1), (32, 16, 8, 8), (2, 4, 0, 1)])
@pytest.mark.parametrize("out_major", ["row", "col"])
@pytest.mark.parametrize("twiddle", [None, (1 << 20, 0), (1 << 14, 5)])
def test_k2_plain_slab_and_global_twiddle_match_pallas(
        rng, L, C, col_offset, ncols, out_major, twiddle):
    B = 3
    x = _planes(rng, (B, L, C))
    got = km.matfft_cols(*_t(x), out_major=out_major, global_twiddle=twiddle,
                         col_offset=col_offset, ncols=ncols)
    want = jmatfft_cols(
        *_j(x), out_major=out_major, col_offset=col_offset, ncols=ncols,
        global_twiddle=(None if twiddle is None
                        else (twiddle[0], jnp.asarray(twiddle[1]))),
        interpret=True)
    assert tuple(got[0].shape) == tuple(want[0].shape)
    assert _rel_err(got, want) < TOL


def test_k2_plain_slab_reads_the_epilogue_at_its_offset(rng):
    x, epi = _planes(rng, (2, 64, 8)), _planes(rng, (8, 64))
    got = km.matfft_cols(*_t(x), epilogue=_t(epi), col_offset=4, ncols=4)
    want = jmatfft_cols(*_j(x), epilogue=_j(epi), col_offset=4, ncols=4,
                        interpret=True)
    assert _rel_err(got, want) < TOL


def test_global_twiddle_plain_is_exact_past_the_f32_angle(rng):
    """m = (row * o) mod n_global past 2^24, where the reference's f32
    angle rounds: the port's two tables stay within 5e-6 of float64."""
    n_global, row_off, n = 1 << 30, (1 << 29) + 7, 256
    x = _planes(rng, (4, n))
    got = km.matfft(*_t(x), global_twiddle=(n_global, row_off))
    y = np.fft.fft(x[0].astype(np.float64) + 1j * x[1], axis=-1)
    m = ((row_off + np.arange(4)[:, None]) * np.arange(n)) % n_global
    want = y * np.exp(-2j * np.pi * m / n_global)
    assert _rel_err(got, (want.real, want.imag)) < TOL


@pytest.mark.parametrize("bad,exc", [
    (lambda x: km.matfft(x[0], x[1][:2]), ValueError),
    (lambda x: km.matfft(x[0].double(), x[1].double()), TypeError),
    (lambda x: km.matfft(*x, epilogue=(x[0][:3], x[1][:3])), ValueError),
    (lambda x: km.matfft(torch.zeros(2, 3 * 4096), torch.zeros(2, 3 * 4096)),
     ValueError),
    (lambda x: km.matfft(x[0].to("meta"), x[1].to("meta")), ValueError),
    (lambda x: km.matfft(*x, epilogue=(x[0][:4], x[1][:4]),
                         global_twiddle=(64, 0)), ValueError),
    (lambda x: km.matfft(*x, global_twiddle=(1 << 33, 0)), ValueError),
    (lambda x: km.matfft(*x, global_twiddle=(96, 0)), ValueError),
    (lambda x: km.matfft(*x, global_twiddle=(64, -1)), ValueError),
    (lambda x: km.matfft_cols(x[0].reshape(1, 16, 4), x[1].reshape(1, 16, 4),
                              col_offset=1, ncols=2), ValueError),
    (lambda x: km.matfft_cols(x[0].reshape(1, 16, 4), x[1].reshape(1, 16, 4),
                              col_offset=0, ncols=3), ValueError),
    (lambda x: km.matfft_cols(x[0].reshape(1, 16, 4), x[1].reshape(1, 16, 4),
                              col_offset=4, ncols=2), ValueError),
])
def test_wrappers_reject_what_the_kernel_does_not_take(rng, bad, exc):
    with pytest.raises(exc):
        bad(_t(_planes(rng, (4, 16))))


# the tile: the port's one tile a kernel against the reference at each of
# the reference's tiles in turn


@pytest.mark.parametrize("n", [16, 256, 1024])
@pytest.mark.parametrize("tile", [1, 8])
def test_k1_and_k3_one_tile_match_pallas_at_each_reference_tile(rng, n,
                                                                tile):
    from repro.kernels.fft.matfft import rfft_leaf as jrfft_leaf
    rows = 20  # ragged against both tiles
    x = _planes(rng, (rows, n))
    got = km.matfft(*_t(x))
    want = jmatfft(*_j(x), batch_tile=tile, interpret=True)
    assert _rel_err(got, want) < TOL
    xr = rng.standard_normal((rows, 2 * n)).astype(np.float32)
    got = km.rfft_leaf(torch.from_numpy(xr))
    want = jrfft_leaf(jnp.asarray(xr), batch_tile=tile, interpret=True)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("L,C", [(16, 64), (256, 32)])
@pytest.mark.parametrize("tile", [2, 8])
@pytest.mark.parametrize("out_major", ["row", "col"])
def test_k2_one_tile_matches_pallas_at_each_reference_tile(
        rng, L, C, tile, out_major):
    x = _planes(rng, (2, L, C))
    got = km.matfft_cols(*_t(x), out_major=out_major)
    want = jmatfft_cols(*_j(x), out_major=out_major, col_tile=tile,
                        interpret=True)
    assert _rel_err(got, want) < TOL


def test_a_launch_key_has_no_tile_entry(rng):
    """A K1, K2 and K4 launch key is (wrapper, shape, major[, options]):
    the options name only the global twiddle, a column slab and K2's
    cluster, never a tile, and no wrapper takes a tile argument."""
    import inspect

    from repro_torch.kernels.fft import stockham as ks
    x = _t(_planes(rng, (8, 1024)))
    km.reset_counts()
    ks.reset_counts()
    km.matfft(*x)
    km.matfft(*x, global_twiddle=(1 << 20, 8))
    x3 = _t(_planes(rng, (2, 1024, 64)))
    km.matfft_cols(*x3, col_offset=32, ncols=32)
    km.matfft_cols(*_t(_planes(rng, (2, 256, 64))), out_major="col")
    ks.stockham_fft(*x)
    assert dict(km.plain_shapes) == {
        ("matfft", (8, 1024), None): 1,
        ("matfft", (8, 1024), None, ("twiddle",)): 1,
        ("matfft_cols", (2, 1024, 64), "row",
         ("slab", 32, "cluster", 2)): 1,
        ("matfft_cols", (2, 256, 64), "col"): 1,
        ("stockham", (8, 1024), None): 1}
    for fn in (km.matfft, km.matfft_cols, km.rfft_leaf, km.rfft_pack_leaf,
               ks.stockham_fft):
        assert not [p for p in inspect.signature(fn).parameters
                    if "tile" in p], fn
