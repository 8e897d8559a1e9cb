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
import repro_torch.fft as tfft
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


@pytest.mark.parametrize("n", [1, 2, 4, 16, 32, 128, 256])
def test_radix_twiddles_are_the_roots_of_unity(n):
    """The radix leaf's one table: W_n^k = exp(-2 pi i k / n), k < n,
    computed in float64 and rounded once to float32."""
    wr, wi = tplan.radix_twiddles(n)
    assert wr.dtype == wi.dtype == np.float32 and wr.shape == (n,)
    want = np.exp(-2j * np.pi * np.arange(n, dtype=np.float64) / n)
    np.testing.assert_array_equal(wr, want.real.astype(np.float32))
    np.testing.assert_array_equal(wi, want.imag.astype(np.float32))
    assert np.abs((wr + 1j * wi.astype(np.float64)) - want).max() < 6e-8


@pytest.mark.parametrize("n1,n2", [(16, 32), (32, 32), (64, 64),
                                   (1024, 1024)])
def test_twiddle_table_bitwise(n1, n2):
    for a, b in zip(tplan.twiddle_table(n1, n2, n1 * n2),
                    jplan.twiddle_table(n1, n2, n1 * n2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4, 8, 256, 512, 1024, 4096, 8192])
def test_rfft_and_stockham_tables_bitwise(n):
    """K3 reads rfft_twiddle(n) (n up to 2*MAX_LEAF), K4 the packed
    stage twiddles at its offsets: the reference's tables, bit for bit."""
    for a, b in zip(tplan.rfft_twiddle(n), jplan.rfft_twiddle(n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tplan.stockham_twiddles(n), jplan.stockham_twiddles(n)):
        np.testing.assert_array_equal(a, b)
    assert tplan.stockham_stage_offsets(n) == jplan.stockham_stage_offsets(n)


@pytest.mark.parametrize("p", [2, 3, 9, 10, 12, 13, 14, 16, 20])
def test_rfft_hbm_bytes_match_reference_at_same_cap(p):
    """The real-input byte counter is the reference's at the port's leaf
    cap: fused (read the row, write the spectrum) while n/2 is one leaf,
    pack + half-length c2c + untangle above it."""
    n = 1 << p
    cap = tplan.MAX_LEAF
    assert tplan.rfft_hbm_bytes(n) == jplan.rfft_hbm_bytes(n, cap)
    if n // 2 <= cap:
        assert tplan.rfft_hbm_bytes(n) == 4 * n + 8 * (n // 2 + 1)


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


def test_resolve_local_r2c_spec():
    s = tspec.resolve("r2c", n=1024, batch_shape=(8,), device="cpu")
    assert (s.kind, s.placement, s.operand_shape) == ("r2c", "local",
                                                      (8, 1024))


@pytest.mark.parametrize("kind", ["r2c", "c2c"])
def test_resolve_local_nd_spec(kind):
    s = tspec.resolve(kind, shape=(64, 64), device="cpu")
    assert (s.shape, s.ndim, s.placement) == ((64, 64), 2, "local")


@pytest.mark.parametrize("kw,exc,match", [
    # ported: plan() builds it from a store, resolve() refuses it
    (dict(kind="c2c", n=256, placement="out_of_core"), ValueError,
     "constructed by repro_torch.fft.plan.* no resolvable FftSpec"),
])
def test_unported_specs_name_their_roadmap_item(kw, exc, match):
    with pytest.raises(exc, match=match):
        tspec.resolve(device="cpu", **kw)
    if kw.get("placement") == "out_of_core":  # and plan() needs store=
        with pytest.raises(ValueError, match="requires store="):
            tfft.plan(device="cpu", **kw)


@pytest.mark.parametrize("kw,grid", [
    # the 2-D pencil: one flattened ring; the 3-D one: a mesh dim an axis
    (dict(kind="c2c", shape=(64, 64), placement="distributed",
          num_devices=4), (4,)),
    (dict(kind="c2c", shape=(16, 16, 16), placement="distributed",
          num_devices=4, axis_sizes=(2, 2)), (2, 2)),
])
def test_pencil_specs_resolve_with_their_grid(kw, grid):
    from repro.core.fft.distributed import pencil_grid as jgrid
    from repro_torch.core.fft.distributed import pencil_grid
    s = tspec.resolve(device="cpu", overlap="off", natural_order=False,
                      fuse_twiddle=True, **kw)
    want = jspec.resolve(overlap="off", natural_order=False,
                         fuse_twiddle=True, **kw)
    assert (s.placement, s.overlap, s.natural_order, s.fuse_twiddle) == (
        want.placement, want.overlap, want.natural_order, want.fuse_twiddle)
    assert s.placement == "distributed" and s.natural_order
    args = (s.shape, kw["num_devices"], kw.get("axis_sizes"))
    assert pencil_grid(*args) == jgrid(*args) == grid


def test_plan_mesh_arguments_are_checked():
    """A mesh's device type is the plan's device; another device, axes=
    without a mesh and a mesh for the out-of-core placement are refused
    before the mesh is read further."""
    class CudaMesh:
        device_type = "cuda"

    with pytest.raises(ValueError, match="disagrees with the mesh"):
        tfft.plan(kind="c2c", n=4096, mesh=CudaMesh(), device="cpu")
    with pytest.raises(ValueError, match="axes= requires mesh="):
        tfft.plan(kind="c2c", n=4096, axes=("data",), device="cpu")
    with pytest.raises(ValueError, match="no mesh="):
        tfft.plan(kind="c2c", n=4096, mesh=CudaMesh(),
                  placement="out_of_core")


def test_plan_fallback_degrade_is_item_7b():
    """fallback="degrade" without a mesh has nothing to degrade: it plans
    as "error" does, the same cached plan; an unknown fallback raises."""
    p = tfft.plan(kind="c2c", n=256, fallback="degrade", device="cpu")
    assert p is tfft.plan(kind="c2c", n=256, device="cpu")
    assert p.placement == "local"
    with pytest.raises(ValueError, match="fallback"):
        tfft.plan(kind="c2c", n=256, fallback="retry", device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(kind="c2c", n=1000), "power of two"),
    (dict(kind="c2c", n=2 * tspec.MAX_LOCAL_N), "single-device"),
    # the mesh placements' rules
    (dict(kind="c2c", n=4096, placement="distributed", num_devices=6),
     "power-of-two device count"),
    (dict(kind="c2c", n=32, placement="distributed", num_devices=8),
     r"n >= D\^2"),
    (dict(kind="c2c", n=256, batch_shape=(10,), placement="segmented",
          num_devices=4), "does not shard evenly"),
    (dict(kind="c2c", n=256, batch_shape=(8,), placement="segmented"),
     "requires mesh="),
    (dict(kind="c2c", n=256, batch_shape=(2, 4), placement="segmented",
          num_devices=2), "1-D batch"),
    (dict(kind="c2c", n=4096, batch_shape=(2,), placement="distributed",
          num_devices=8), "ONE global signal"),
    (dict(kind="r2c", n=4096, placement="distributed", num_devices=8),
     "r2c"),
    (dict(kind="c2c", n=4096, placement="distributed", num_devices=8,
          overlap=3), "chunks must divide"),
    (dict(kind="c2c", n=4096, placement="distributed", num_devices=8,
          overlap="sometimes"), "overlap must be"),
    (dict(kind="c2c", n=4096, placement="distributed", num_devices=8,
          axis_sizes=(4, 4)), "do not multiply"),
    (dict(kind="c2c", n=256, layout="tiled"), "layout"),
    (dict(kind="c2c", n=256, impl="cufft"), "impl"),
    (dict(kind="c2c", n=256, verify="crc"), "verify"),
    (dict(kind="c2c", n=256, device="mps"), "device"),
])
def test_resolve_rejects_bad_specs(kw, match):
    with pytest.raises(ValueError, match=match):
        tspec.resolve(**{"device": "cpu", **kw})


@pytest.mark.parametrize("shape", [(4096,), (64,), (1 << 26,), (64, 64),
                                   (8, 64), (2 * tspec.MAX_LOCAL_N,)])
@pytest.mark.parametrize("batch", [(), (8,), (6,), (2, 4)])
@pytest.mark.parametrize("num_devices", [None, 1, 4, 8])
def test_auto_placement_matches_the_reference(shape, batch, num_devices):
    """The placement heuristic with and without a mesh, against the
    reference's (the port's cap on one device is the reference's)."""
    args = (shape, int(np.prod(batch)), len(batch), num_devices)
    try:
        want = jspec.resolve_placement(*args)
    except ValueError:
        with pytest.raises(ValueError):
            tspec.resolve_placement(*args)
        return
    assert tspec.resolve_placement(*args) == want


@pytest.mark.parametrize("n,d,overlap", [
    (4096, 8, "auto"), (1 << 26, 8, "auto"), (1 << 26, 128, "auto"),
    (1 << 12, 8, 4), (1 << 12, 8, 8), (1 << 20, 4, "off"),
    (1 << 27, 2, "auto")])
def test_distributed_spec_matches_the_reference(n, d, overlap):
    """1-D distributed resolution: the overlap knob resolved the same way,
    and the knobs of other placements normalized away."""
    kw = dict(kind="c2c", n=n, placement="distributed", num_devices=d,
              axes=("data",), overlap=overlap, fuse_twiddle=True)
    got = tspec.resolve(device="cpu", **kw)
    want = jspec.resolve(**kw)
    assert (got.overlap, got.fuse_twiddle, got.natural_order, got.axes) == (
        want.overlap, want.fuse_twiddle, want.natural_order, want.axes)
    seg = tspec.resolve(kind="c2c", n=256, batch_shape=(d,), num_devices=d,
                        axes=("data",), placement="segmented",
                        fuse_twiddle=True, overlap=4, device="cpu")
    assert (seg.overlap, seg.fuse_twiddle, seg.axes) == ("off", False,
                                                        ("data",))


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspec.resolve_device("cuda")
