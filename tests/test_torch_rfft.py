"""The port's real-input kernel K3 (`rfft_leaf`, `rfft_pack_leaf`), its
Stockham kernel K4 (`stockham_fft`) and the executors that drive them.

On the CPU the wrappers run the plain PyTorch versions; those are held to
the JAX package's Pallas kernels in interpret mode. The CUDA kernels
themselves are held to the plain versions in test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fft import executors as jex
from repro.kernels.fft import matfft as jm
from repro.kernels.fft import plan as jplan
from repro.kernels.fft import stockham as js
from repro_torch.fft import executors as tex
from repro_torch.kernels.fft import matfft as km
from repro_torch.kernels.fft import stockham as ks

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)


def _rel_err(got, want) -> float:
    g = np.asarray(got[0]) + 1j * np.asarray(got[1])
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    return float(np.abs(g - w).max() / (np.abs(w).max() or 1.0))


def _real(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# K3


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                               4096, 8192])
@pytest.mark.parametrize("rows", [1, 3, 17])
@pytest.mark.parametrize("untangle", [True, False])
def test_k3_plain_matches_pallas(rng, n, rows, untangle):
    x = _real(rng, (rows, n))
    if untangle:
        got = km.rfft_leaf(torch.from_numpy(x))
        want = jm.rfft_leaf(jnp.asarray(x), interpret=True)
    else:
        got = km.rfft_pack_leaf(torch.from_numpy(x))
        want = jm.rfft_pack_leaf(jnp.asarray(x), interpret=True)
    assert tuple(got[0].shape) == tuple(want[0].shape)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 256)])
def test_untangle_matches_reference(rng, shape):
    m = shape[-1]
    y = (_real(rng, shape), _real(rng, shape))
    v = jplan.rfft_twiddle(2 * m)
    got = km.untangle_half_spectrum(*(torch.from_numpy(a) for a in y),
                                    *(torch.from_numpy(a) for a in v))
    want = jm.untangle_half_spectrum(*(jnp.asarray(a) for a in y),
                                     *(jnp.asarray(a) for a in v))
    assert tuple(got[0].shape) == (*shape[:-1], m + 1)
    assert _rel_err(got, want) < TOL
    assert not got[1][..., -1].any()  # the Nyquist bin is real


def test_k3_cpu_tensors_take_the_plain_version(rng):
    km.reset_counts()
    x = torch.from_numpy(_real(rng, (4, 64)))
    km.rfft_leaf(x)
    km.rfft_pack_leaf(x)
    assert (km.rfft_leaf.launches, km.rfft_pack_leaf.launches) == (0, 0)
    assert (km.rfft_leaf_plain.calls, km.rfft_pack_leaf_plain.calls) == (1, 1)


@pytest.mark.parametrize("bad,exc,match", [
    (torch.zeros(3, 2), ValueError, "n >= 4"),
    (torch.zeros(3, 12), ValueError, "power of two"),
    (torch.zeros(3, 4 * 4096), ValueError, "capacity"),
    (torch.zeros(3, 8, dtype=torch.float64), TypeError, "float32"),
    (torch.zeros(8), ValueError, "2-D"),
    (torch.zeros(3, 8, device="meta"), ValueError, "CUDA or CPU"),
])
def test_k3_wrappers_reject_what_the_kernel_does_not_take(bad, exc, match):
    for fn in (km.rfft_leaf, km.rfft_pack_leaf):
        with pytest.raises(exc, match=match):
            fn(bad)


# ---------------------------------------------------------------------------
# K4


@pytest.mark.parametrize("n", [2, 4, 16, 256, 1024, 4096])
def test_k4_plain_matches_pallas(rng, n):
    x = (_real(rng, (3, n)), _real(rng, (3, n)))
    ks.reset_counts()
    got = ks.stockham_fft(*(torch.from_numpy(a) for a in x))
    assert (ks.stockham_fft.launches, ks.stockham_fft_plain.calls) == (0, 1)
    want = js.stockham_fft(*(jnp.asarray(a) for a in x), interpret=True)
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("n", [1 << p for p in range(1, 13)])
def test_k4_grouped_plain_equals_plain_bitwise(rng, n):
    """The kernel's groups of up to four stages (every length of the short
    group, log2 n mod 4) give the stage-by-stage plain version's bits."""
    x = tuple(torch.from_numpy(_real(rng, (5, n))) for _ in range(2))
    got = ks._stockham_grouped_plain(*x)
    want = ks.stockham_fft_plain(*x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [8, 32, 512, 2048])
def test_k4_grouped_plain_matches_pallas(rng, n):
    x = (_real(rng, (3, n)), _real(rng, (3, n)))
    got = ks._stockham_grouped_plain(*(torch.from_numpy(a) for a in x))
    want = js.stockham_fft(*(jnp.asarray(a) for a in x), interpret=True)
    assert _rel_err(got, want) < TOL


def test_k4_length_one_returns_its_input(rng):
    x = tuple(torch.from_numpy(_real(rng, (5, 1))) for _ in range(2))
    got = ks.stockham_fft(*x)
    assert got[0] is x[0] and got[1] is x[1]


@pytest.mark.parametrize("n,exc", [(8192, ValueError), (12, ValueError)])
def test_k4_rejects_what_the_kernel_does_not_take(n, exc):
    with pytest.raises(exc):
        ks.stockham_fft(torch.zeros(2, n), torch.zeros(2, n))


# ---------------------------------------------------------------------------
# executors


@pytest.mark.parametrize("n", [4, 64, 8192, 1 << 14])
def test_rfft_and_irfft_match_reference(rng, n):
    """At 2^14 the port's half length 8192 exceeds its 4096-point leaf, so
    it packs, runs the level-1 path and untangles with torch ops; the
    reference's 16384-point leaf takes it in one fused kernel."""
    x = _real(rng, (3, n))
    km.reset_counts()
    got = tex.rfft(torch.from_numpy(x))
    fused = n // 2 <= 4096
    assert km.rfft_leaf_plain.calls == int(fused)
    assert km.matfft_cols_plain.calls == (0 if fused else 2)
    want = jex.rfft(jnp.asarray(x))
    assert _rel_err(got, want) < TOL
    back = tex.irfft(*got)
    want_back = np.asarray(jex.irfft(*want))
    assert np.abs(back.numpy() - want_back).max() / np.abs(x).max() < TOL
    assert np.abs(back.numpy() - x).max() / np.abs(x).max() < TOL


@pytest.mark.parametrize("impl", ["stockham", "ref"])
@pytest.mark.parametrize("n", [2, 256])
def test_rfft_legacy_path_matches_numpy(rng, impl, n):
    x = _real(rng, (2, n))
    got = tex.rfft(torch.from_numpy(x), impl=impl)
    want = np.fft.rfft(x.astype(np.float64))
    assert _rel_err(got, (want.real, want.imag)) < TOL
    back = tex.irfft(*got, impl=impl)
    assert np.abs(back.numpy() - x).max() / np.abs(x).max() < TOL


@pytest.mark.parametrize("n_last", [64, 8192, 1 << 14])
def test_rfft_pack_pass_matches_reference(rng, n_last):
    x = _real(rng, (2, n_last))
    got = tex.rfft_pack_pass(torch.from_numpy(x), n_last)
    want = jex.rfft_pack_pass(jnp.asarray(x), n_last)
    assert tuple(got[0].shape) == (2, n_last // 2)
    assert _rel_err(got, want) < TOL


def test_stockham_copy_path_matches_reference(rng):
    """2^15 = 128 x 256: the level-1 copy path with K4 leaves (two K4
    calls, the outer twiddle applied after the first)."""
    x = (_real(rng, (2, 1 << 15)), _real(rng, (2, 1 << 15)))
    ks.reset_counts()
    got = tex.fft(*(torch.from_numpy(a) for a in x), impl="stockham")
    assert ks.stockham_fft_plain.calls == 2
    want = jex.fft(*(jnp.asarray(a) for a in x), impl="stockham")
    assert _rel_err(got, want) < TOL


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("tile", [1, 8])
def test_k4_and_k3_pack_one_tile_match_pallas_at_each_reference_tile(
        rng, n, tile):
    """K4 and the packed K3 at the port's one tile, within 5e-6 of the
    Pallas kernel at each of the reference's tiles."""
    x = [rng.standard_normal((12, n)).astype(np.float32) for _ in range(2)]
    got = ks.stockham_fft(*map(torch.from_numpy, x))
    want = js.stockham_fft(*map(jnp.asarray, x), batch_tile=tile,
                           interpret=True)
    assert _rel_err(got, want) < TOL
    xr = _real(rng, (12, 2 * n))
    got = km.rfft_pack_leaf(torch.from_numpy(xr))
    want = jm.rfft_pack_leaf(jnp.asarray(xr), batch_tile=tile,
                             interpret=True)
    assert _rel_err(got, want) < TOL
