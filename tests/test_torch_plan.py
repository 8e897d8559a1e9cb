"""The port's plan tables and oracles against the JAX package's.

The PyTorch port (`repro_torch`) keeps its own copy of
`kernels/fft/plan.py` with a leaf cap sized for a Hopper block; its
tables must stay bit-identical to the reference's, and its torch oracles
must agree with the reference's jnp oracles.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fft import spec as jspec
from repro.kernels.fft import plan as jplan
from repro.kernels.fft import ref as jref
from repro_torch.fft import spec as tspec
from repro_torch.kernels.fft import plan as tplan
from repro_torch.kernels.fft import ref as tref

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)


def _rel_err(got_r, got_i, want_r, want_i) -> float:
    got = np.asarray(got_r) + 1j * np.asarray(got_i)
    want = np.asarray(want_r) + 1j * np.asarray(want_i)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def test_port_max_leaf_fits_a_hopper_block():
    assert tplan.MAX_LEAF == 4096
    # one device takes every length the reference takes on one device
    assert tspec.MAX_LOCAL_N == jspec.MAX_LOCAL_N == 1 << 28


@pytest.mark.parametrize("n", [1, 2, 16, 256, 1024, 4096])
def test_dft_matrix_bitwise(n):
    for a, b in zip(tplan.dft_matrix(n), jplan.dft_matrix(n)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n1,n2", [(16, 32), (32, 32), (64, 64),
                                   (1024, 1024)])
def test_twiddle_table_bitwise(n1, n2):
    for a, b in zip(tplan.twiddle_table(n1, n2, n1 * n2),
                    jplan.twiddle_table(n1, n2, n1 * n2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [4, 256, 4096])
def test_rfft_and_stockham_tables_bitwise(n):
    for a, b in zip(tplan.rfft_twiddle(n), jplan.rfft_twiddle(n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tplan.stockham_twiddles(n), jplan.stockham_twiddles(n)):
        np.testing.assert_array_equal(a, b)
    assert tplan.stockham_stage_offsets(n) == jplan.stockham_stage_offsets(n)


@pytest.mark.parametrize("p", range(1, 25))
def test_split_pow2_invariants(p):
    n = 1 << p
    n1, n2 = tplan.split_pow2(n, tplan.MAX_LEAF)
    assert n1 * n2 == n
    assert n1 <= tplan.MAX_LEAF and n2 <= tplan.MAX_LEAF
    assert tplan.is_pow2(n1) and tplan.is_pow2(n2)
    # the factorization is the reference's, only the leaf cap differs
    assert (n1, n2) == jplan.split_pow2(n, jplan.MAX_LEAF)


@pytest.mark.parametrize("p", [1, 8, 10, 12, 13, 15, 20, 24])
def test_make_plan_and_byte_counters_match_reference_at_same_cap(p):
    n = 1 << p
    cap = tplan.MAX_LEAF
    got, want = tplan.make_plan(n), jplan.make_plan(n, cap)
    assert ((got.n, got.levels, got.n1, got.n2)
            == (want.n, want.levels, want.n1, want.n2))
    assert got.gemm_macs == want.gemm_macs
    for layout in ("zero_copy", "copy"):
        assert (tplan.fft_hbm_bytes(n, layout)
                == jplan.fft_hbm_bytes(n, layout, cap))


@pytest.mark.parametrize("p", [25, 26, 27, 28])
def test_make_plan_three_levels_past_max_leaf_squared(p):
    """Lengths the reference plans in two levels of its 16384-point leaf
    take three levels of the port's: a leaf first pass, a level-2 second."""
    n = 1 << p
    got = tplan.make_plan(n)
    assert got.levels == 3 and got.n1 * got.n2 == n
    assert got.n1 <= tplan.MAX_LEAF
    assert tplan.make_plan(got.n2).levels == 2
    # zero_copy: pass 1, pass 2 (two passes) and the two transposes around
    # it; copy: the two-level copy path of the second pass besides
    assert tplan.fft_hbm_bytes(n, "zero_copy") == 5 * 16 * n
    assert tplan.fft_hbm_bytes(n, "copy") == 9 * 16 * n
    f1 = tplan.split_pow2(got.n1)
    assert got.gemm_macs == (4.0 * n * sum(f1)
                             + got.n1 * tplan.make_plan(got.n2).gemm_macs)
    assert tspec.resolve("c2c", n=n, device="cpu").placement == "local"


def test_dft_matrix_unitary():
    n = 64
    wr, wi = tplan.dft_matrix(n)
    w = wr + 1j * wi
    assert np.abs(w @ w.conj().T / n - np.eye(n)).max() < 1e-5


def test_stockham_twiddle_packing():
    n = 256
    offs = tplan.stockham_stage_offsets(n)
    assert offs[0] == (0, n // 2, 1)
    assert sum(l for _, l, _ in offs) == n - 1


@pytest.mark.parametrize("n1,n2", [(32, 32), (16, 64)])
def test_four_step_ref_algebra(rng, n1, n2):
    """The torch Bailey reference equals torch.fft and the jnp reference."""
    xr = rng.standard_normal((4, n1 * n2)).astype(np.float32)
    xi = rng.standard_normal((4, n1 * n2)).astype(np.float32)
    yr, yi = tref.four_step_ref(torch.from_numpy(xr), torch.from_numpy(xi),
                                n1, n2)
    wr, wi = tref.fft_ref(torch.from_numpy(xr), torch.from_numpy(xi))
    assert _rel_err(yr, yi, wr, wi) < TOL
    jr, ji = jref.four_step_ref(jnp.asarray(xr), jnp.asarray(xi), n1, n2)
    assert _rel_err(yr, yi, jr, ji) < TOL


def test_fft_ref_and_ifft_ref_match_jnp(rng):
    xr = rng.standard_normal((3, 512)).astype(np.float32)
    xi = rng.standard_normal((3, 512)).astype(np.float32)
    tx = (torch.from_numpy(xr), torch.from_numpy(xi))
    jx = (jnp.asarray(xr), jnp.asarray(xi))
    assert _rel_err(*tref.fft_ref(*tx), *jref.fft_ref(*jx)) < TOL
    assert _rel_err(*tref.ifft_ref(*tx), *jref.ifft_ref(*jx)) < TOL


# ---------------------------------------------------------------------------
# spec resolution: this slice's scope and the device rule


def test_resolve_local_cpu_spec():
    s = tspec.resolve("c2c", n=1024, batch_shape=(8,), device="cpu")
    assert (s.placement, s.device, s.operand_shape) == ("local", "cpu",
                                                        (8, 1024))


@pytest.mark.parametrize("kw,item", [
    (dict(kind="r2c", n=256), "item 5"),
    (dict(kind="c2c", shape=(64, 64)), "item 6"),
    (dict(kind="c2c", n=256, placement="segmented"), "item 7"),
    (dict(kind="c2c", n=256, placement="distributed"), "item 7"),
    (dict(kind="c2c", n=256, placement="out_of_core"), "item 8"),
])
def test_unported_specs_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        tspec.resolve(device="cpu", **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(kind="c2c", n=1000), "power of two"),
    (dict(kind="c2c", n=2 * tspec.MAX_LOCAL_N), "single-device"),
    (dict(kind="c2c", n=256, layout="tiled"), "layout"),
    (dict(kind="c2c", n=256, impl="cufft"), "impl"),
    (dict(kind="c2c", n=256, verify="crc"), "verify"),
    (dict(kind="c2c", n=256, device="mps"), "device"),
])
def test_resolve_rejects_bad_specs(kw, match):
    with pytest.raises(ValueError, match=match):
        tspec.resolve(**{"device": "cpu", **kw})


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspec.resolve_device("cuda")
