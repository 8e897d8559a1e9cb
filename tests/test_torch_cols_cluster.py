"""K2's thread-block clusters (`plan.col_cluster`): which launches form
them, the checks the kernel makes of them, the launch key that records
them, and the plain version at the lengths that form them (L = 2048 and
4096) against the JAX package's Pallas kernel in interpret mode. The
clusters themselves run on the card (test_torch_gpu.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.fft.matfft import matfft_cols as jmatfft_cols
from repro_torch.kernels.fft import matfft as km
from repro_torch.kernels.fft import plan as tplan

torch.set_num_threads(1)

TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)
G = tplan.CLUSTER_COLS


def _planes(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel_err(got, want) -> float:
    g = np.asarray(got[0]) + 1j * np.asarray(got[1])
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    return float(np.abs(g - w).max() / (np.abs(w).max() or 1.0))


@pytest.mark.parametrize("L", [1 << p for p in range(1, 13)])
def test_col_cluster_at_every_slab_and_tile(L):
    """For every slab width at the one tile: a block's R columns are
    min(MAX_LEAF // L, nc); R < G <= nc from L = CLUSTER_MIN_L on forms a
    cluster of K = G / R <= 8 blocks, anything else none, and planes off
    16 bytes none; the grid (nc / R blocks a matrix) is whole clusters;
    and the kernel's own checks accept the pair."""
    for nc in (1 << p for p in range(13)):
        R, K = tplan.col_cluster(L, nc)
        assert R == min(tplan.MAX_LEAF // L, nc)
        if R < G <= nc and L >= tplan.CLUSTER_MIN_L:
            assert K * R == G and 2 <= K <= tplan.MAX_CLUSTER
        else:
            assert K == 1
        assert nc % R == 0 and (nc // R) % K == 0
        tplan.check_col_cluster(L, R, nc, K)
        assert tplan.col_cluster(L, nc, aligned=False) == (R, 1)
        tplan.check_col_cluster(L, R, nc, 1, aligned=False)


def test_default_tiles_cluster_from_1024_on():
    got = {L: tplan.col_cluster(L, 4096) for L in (256, 512, 1024, 2048,
                                                   4096)}
    assert got == {256: (16, 1), 512: (8, 1), 1024: (4, 2), 2048: (2, 4),
                   4096: (1, 8)}
    assert tplan.col_cluster(4096, 4) == (1, 1)  # a slab below a sector


@pytest.mark.parametrize("L,R,nc,K,aligned", [
    (4096, 1, 8, 4, True), (2048, 2, 8, 8, True), (1024, 4, 8, 4, True),
    (4096, 1, 16, 16, True), (4096, 3, 9, 1, True), (1024, 4, 6, 1, True),
    (1024, 4, 4, 2, True), (2048, 2, 8, 3, True), (4096, 1, 4, 8, True),
    (512, 8, 64, 2, True), (16, 1, 8, 8, True), (4096, 1, 64, 8, False)])
def test_check_col_cluster_rejects_what_the_kernel_refuses(L, R, nc, K,
                                                           aligned):
    with pytest.raises(ValueError):
        tplan.check_col_cluster(L, R, nc, K, aligned)


@pytest.mark.parametrize("L,R,nc,K", [(4096, 1, 8, 8), (2048, 2, 8, 4),
                                      (1024, 4, 8, 2), (1024, 4, 4096, 2),
                                      (256, 16, 64, 1), (4096, 1, 1, 1),
                                      (32, 1, 8, 8)])
def test_check_col_cluster_accepts_what_the_kernel_takes(L, R, nc, K):
    tplan.check_col_cluster(L, R, nc, K)


def _off16(a: np.ndarray) -> torch.Tensor:
    """``a`` in a tensor whose data starts 4 bytes past 16."""
    t = torch.zeros(a.size + 1)[1:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    assert t.data_ptr() % 16 == 4
    return t


def test_the_launch_key_records_the_cluster(rng):
    """Each call's key: K > 1 as ("cluster", K) after the other options;
    a one-block call carries none, and so does a call on planes off 16
    bytes."""
    km.reset_counts()
    calls = [((1, 1024, 16), {}), ((1, 2048, 8), {}), ((1, 4096, 8), {}),
             ((1, 4096, 4), {}), ((1, 512, 16), {}),
             ((1, 4096, 16), {"col_offset": 8, "ncols": 8,
                              "global_twiddle": (1 << 20, 0)}),
             ((1, 4096, 16), {"col_offset": 4, "ncols": 4})]
    for shape, kw in calls:
        km.matfft_cols(*(torch.from_numpy(a) for a in _planes(rng, shape)),
                       out_major="col", **kw)
    km.matfft_cols(*(_off16(a) for a in _planes(rng, (2, 2048, 8))),
                   out_major="row")
    assert dict(km.plain_shapes) == {
        ("matfft_cols", (1, 1024, 16), "col", ("cluster", 2)): 1,
        ("matfft_cols", (1, 2048, 8), "col", ("cluster", 4)): 1,
        ("matfft_cols", (1, 4096, 8), "col", ("cluster", 8)): 1,
        ("matfft_cols", (1, 4096, 4), "col"): 1,
        ("matfft_cols", (1, 512, 16), "col"): 1,
        ("matfft_cols", (2, 2048, 8), "row"): 1,
        ("matfft_cols", (1, 4096, 16), "col",
         ("twiddle", "slab", 8, "cluster", 8)): 1,
        ("matfft_cols", (1, 4096, 16), "col", ("slab", 4)): 1}
    assert km.matfft_cols.launches == 0


@pytest.mark.parametrize("L,C,off,nc,twiddle", [
    (2048, 16, 8, 8, (1 << 22, 8)), (2048, 8, 0, None, None),
    (4096, 8, 0, 8, (1 << 24, 0)), (4096, 16, 8, 8, None)])
@pytest.mark.parametrize("out_major", ["row", "col"])
def test_k2_plain_at_cluster_lengths_matches_pallas(rng, L, C, off, nc,
                                                    twiddle, out_major):
    x = _planes(rng, (1, L, C))
    got = km.matfft_cols(*(torch.from_numpy(a) for a in x),
                         out_major=out_major, global_twiddle=twiddle,
                         col_offset=off, ncols=nc)
    want = jmatfft_cols(
        *(jnp.asarray(a) for a in x), out_major=out_major, col_offset=off,
        ncols=nc, global_twiddle=(None if twiddle is None
                                  else (twiddle[0], jnp.asarray(twiddle[1]))),
        interpret=True)
    assert tuple(got[0].shape) == tuple(want[0].shape)
    assert _rel_err(got, want) < TOL
