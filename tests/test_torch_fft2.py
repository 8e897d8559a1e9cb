"""The port's N-D local transforms (`plan(shape=...)`, fft2/ifft2/rfft2/
irfft2, fftn, `fft_conv2d`) against the JAX package's and numpy, on the CPU
through the kernels' plain versions.

Mirrors the local cases of tests/test_fft2_plan.py with the port's caps;
the pencil and segmented cases wait for the distributed placements.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.fft as jfft
import repro_torch.fft as tfft
from repro.core import spectral as jspectral
from repro_torch.core import spectral
from repro_torch.fft import executors
from repro_torch.fft import spec as tspec
from repro_torch.kernels.fft import matfft as km
from repro_torch.kernels.fft import plan as tplan

# the suite runs one process per core (xdist): keep torch to one thread
# so these tests do not crowd the timing-sensitive ones beside them
torch.set_num_threads(1)

TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)


def _rel_err(got, want) -> float:
    g = np.asarray(got[0]) + 1j * np.asarray(got[1])
    if isinstance(want, tuple):
        want = np.asarray(want[0]) + 1j * np.asarray(want[1])
    return float(np.abs(g - want).max() / (np.abs(want).max() or 1.0))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _planes(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _resolve(**kw):
    return tspec.resolve(**{"kind": "c2c", "device": "cpu", **kw})


# ---------------------------------------------------------------------------
# N-D spec resolution


def test_shape_tuple_normalization():
    s = _resolve(n=1024)
    assert s.shape == (1024,) and s.ndim == 1 and s.n == 1024
    s = _resolve(shape=(64, 128))
    assert s.shape == (64, 128) and s.ndim == 2 and s.n == 64 * 128
    assert s.operand_shape == (64, 128)
    # an int shape is 1-D sugar too; a list normalizes to a tuple
    assert _resolve(shape=256).shape == (256,)
    assert _resolve(shape=[32, 64]).shape == (32, 64)


def test_scalar_n_sugar_same_cache_key():
    tfft.clear_plan_cache()
    p1 = tfft.plan(kind="c2c", n=512, batch_shape=(2,), device="cpu")
    p2 = tfft.plan(kind="c2c", shape=(512,), batch_shape=(2,), device="cpu")
    assert p2 is p1
    assert tfft.cache_info()["hits"] == 1
    assert _resolve(n=512) == _resolve(shape=(512,))
    # an N-D spec with the same point count is its own entry
    p3 = tfft.plan(kind="c2c", shape=(16, 32), batch_shape=(2,),
                   device="cpu")
    assert p3 is not p1 and p3.n == p1.n


def test_exactly_one_of_n_and_shape():
    with pytest.raises(ValueError, match="exactly one"):
        _resolve(n=64, shape=(64,))
    with pytest.raises(ValueError, match="exactly one"):
        _resolve()


def test_non_pow2_axis_raises_naming_the_axis():
    with pytest.raises(ValueError, match=r"axis 1 of shape \(64, 96\)"):
        _resolve(shape=(64, 96))
    with pytest.raises(ValueError, match="axis 0"):
        _resolve(shape=(48, 64))
    with pytest.raises(ValueError, match="power of two"):
        tfft.plan(kind="c2c", shape=(64, 96), device="cpu")
    with pytest.raises(ValueError, match=">= 2"):
        _resolve(shape=(1, 64))


def test_r2c_non_contiguous_axis_raises():
    with pytest.raises(ValueError, match="contiguous"):
        _resolve(kind="r2c", shape=(64, 128), r2c_axis=0)
    with pytest.raises(ValueError, match="contiguous"):
        _resolve(kind="r2c", shape=(64, 128), r2c_axis=-2)
    # -1 and its positive alias are the supported (normalized) axis
    assert _resolve(kind="r2c", shape=(64, 128), r2c_axis=-1).kind == "r2c"
    assert _resolve(kind="r2c", shape=(64, 128), r2c_axis=1).kind == "r2c"
    with pytest.raises(ValueError, match="contiguous"):
        tfft.plan(kind="r2c", shape=(64, 128), r2c_axis=0, device="cpu")


def test_local_nd_axis_caps():
    # the contiguous axis caps at MAX_LOCAL_N, earlier axes at the JAX
    # package's leaf (16384): (8192, 8192) plans locally in both packages
    assert tspec.MAX_EARLIER_AXIS == 16384 > tplan.MAX_LEAF
    for shape in ((64, 2 * tplan.MAX_LEAF), (8192, 8192),
                  (tspec.MAX_EARLIER_AXIS, 64)):
        assert _resolve(shape=shape, placement="local").placement == "local"
        assert _resolve(shape=shape).placement == "local"
        assert tspec.resolve_placement(shape) == "local"
    with pytest.raises(ValueError, match="MAX_EARLIER_AXIS"):
        _resolve(shape=(2 * tspec.MAX_EARLIER_AXIS, 64), placement="local")
    with pytest.raises(ValueError, match="MAX_EARLIER_AXIS"):
        tspec.resolve_placement((2 * tspec.MAX_EARLIER_AXIS, 64))
    with pytest.raises(ValueError, match="MAX_LOCAL_N"):
        _resolve(shape=(64, 2 * tspec.MAX_LOCAL_N))


# ---------------------------------------------------------------------------
# the cost model against the port's own plan.py


def test_fftn_byte_counters():
    shape = (128, 4096)
    zc = tplan.fftn_hbm_bytes(shape, "zero_copy")
    naive = tplan.fftn_hbm_bytes(shape, "copy")
    assert zc < naive
    # zero-copy: contiguous-axis pass + ONE col pass, no transpose bytes
    n = 128 * 4096
    assert zc == 128 * tplan.fft_hbm_bytes(4096) + 2 * 2 * 4 * n
    # naive: same passes + a transpose round trip there and back
    assert naive == zc + 2 * (2 * 2 * 4 * n)
    p = tfft.plan(kind="c2c", shape=shape, device="cpu")
    assert p.hbm_bytes_per_row == zc
    assert tfft.plan(kind="c2c", shape=shape, layout="copy",
                     device="cpu").hbm_bytes_per_row == naive
    # rfft2 undercuts the complex transform
    assert tplan.rfftn_hbm_bytes(shape) < zc
    assert (tfft.plan(kind="r2c", shape=shape, device="cpu")
            .hbm_bytes_per_row == tplan.rfftn_hbm_bytes(shape))


@pytest.mark.parametrize("shape", [(128, 4096), (64, 256), (8, 16, 32),
                                   (512, 512, 512), (4096, 1 << 15)])
def test_byte_counters_equal_the_reference_within_one_leaf(shape):
    """Every earlier axis <= the port's MAX_LEAF: one column pass each,
    counted exactly as the reference counts it."""
    from repro.kernels.fft import plan as jplan
    for layout in ("zero_copy", "copy"):
        assert (tplan.fftn_hbm_bytes(shape, layout)
                == jplan.fftn_hbm_bytes(shape, layout))
    if shape[-1] // 2 <= tplan.MAX_LEAF:  # else the port's half is level 1
        assert tplan.rfftn_hbm_bytes(shape) == jplan.rfftn_hbm_bytes(shape)


def test_byte_counters_count_the_long_leading_axis():
    """An earlier axis past MAX_LEAF runs between two transposes as a
    level-1 transform: both round trips and both K2 passes counted."""
    n0, n1 = 8192, 64
    points = n0 * n1
    per_pass = 2 * 2 * 4 * points
    rows = tplan.fft_hbm_bytes(n1)  # per row of the contiguous axis
    level1 = n1 * tplan.fft_hbm_bytes(n0)  # 2 passes of the column rows
    assert level1 == 2 * per_pass
    assert tplan.fftn_hbm_bytes((n0, n1)) == n0 * rows + level1 + 2 * per_pass
    assert tplan.fftn_hbm_bytes((n0, n1), "copy") == (
        n0 * rows + n1 * tplan.fft_hbm_bytes(n0, "copy") + 2 * per_pass)
    # r2c: the half-width spectrum takes the same detour
    half = points // 2
    m = n1 // 2
    want = (n0 * (4 * n1 + 8 * m)                       # K3 packed pass
            + (n1 // 2) * tplan.fft_hbm_bytes(n0) + 2 * 16 * half
            + 16 * half + 8 * n0 * (m + 1))             # untangle
    assert tplan.rfftn_hbm_bytes((n0, n1)) == want
    assert (tfft.plan(kind="r2c", shape=(n0, n1), device="cpu")
            .hbm_bytes_per_row == want)


def test_fftn_flops_and_macs():
    p = tfft.plan(kind="c2c", shape=(64, 256), batch_shape=(3,),
                  device="cpu")
    n = 64 * 256
    assert p.flops_per_row == pytest.approx(5.0 * n * np.log2(n))
    assert p.flops == 3 * p.flops_per_row
    # per-axis GEMM sum: 64 rows of len-256 + 256 cols of len-64
    want = (64 * tplan.make_plan(256).gemm_macs
            + 256 * tplan.make_plan(64).gemm_macs)
    assert p.gemm_macs_per_row == want
    pr = tfft.plan(kind="r2c", shape=(64, 256), batch_shape=(3,),
                   device="cpu")
    assert pr.flops_per_row < p.flops_per_row
    assert pr.gemm_macs_per_row < p.gemm_macs_per_row
    assert not pr.fused_untangle  # the N-D untangle runs after the passes
    # the same counts as the reference's planner
    for kind in ("c2c", "r2c"):
        jp = jfft.plan(kind=kind, shape=(64, 256), batch_shape=(3,))
        tp = tfft.plan(kind=kind, shape=(64, 256), batch_shape=(3,),
                       device="cpu")
        assert tp.flops == jp.flops and tp.gemm_macs == jp.gemm_macs
        assert tp.ndim == jp.ndim == 2


def test_plan_leaf_covers_the_longest_axis():
    assert tfft.plan(kind="c2c", shape=(8192, 64),
                     device="cpu").levels == 2
    assert tfft.plan(kind="c2c", shape=(64, 4096), device="cpu").levels == 1
    # fast r2c halves only the contiguous axis
    assert tfft.plan(kind="r2c", shape=(64, 8192), device="cpu").levels == 1
    assert "shape=(8, 16, 32)" in repr(tfft.plan(kind="c2c",
                                                 shape=(8, 16, 32),
                                                 device="cpu"))


# ---------------------------------------------------------------------------
# execution against numpy


def test_fft2_local_and_roundtrip(rng):
    for shape in ((64, 64), (16, 1 << 15)):  # incl. a level-1 contiguous axis
        xr, xi = _planes(rng, (2, *shape))
        p = tfft.plan(kind="c2c", shape=shape, batch_shape=(2,), device="cpu")
        yr, yi = p.execute(xr, xi)
        assert _rel_err((yr, yi), np.fft.fft2(xr + 1j * xi)) < TOL
        br, bi = p.execute_inverse(yr, yi)
        assert float((br - torch.from_numpy(xr)).abs().max()) \
            / np.abs(xr).max() < 1e-5
        p.execute(xr, xi)
        assert p.build_counts["forward"] == 1


def test_rfft2_local_and_inverse(rng):
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    sr, si = tfft.rfft2(x, device="cpu")
    assert tuple(sr.shape) == (2, 64, 65)
    assert _rel_err((sr, si), np.fft.rfft2(x)) < TOL
    back = tfft.irfft2(sr, si, device="cpu")
    assert float((back - torch.from_numpy(x)).abs().max()) \
        / np.abs(x).max() < 1e-5


def test_fft2_helpers_match_plan(rng):
    xr, xi = _planes(rng, (32, 64))
    yr, yi = tfft.fft2(xr, xi, device="cpu")
    p = tfft.plan(kind="c2c", shape=(32, 64), device="cpu")
    wr, wi = p.execute(xr, xi)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)
    br, bi = tfft.ifft2(yr, yi, device="cpu")
    assert _rel_err((br, bi), (xr + 1j * xi).astype(np.complex64)) < TOL
    x = xr
    s = tfft.rfft2(x, device="cpu")
    q = tfft.plan(kind="r2c", shape=(32, 64), device="cpu")
    w = q.execute_real(x)
    assert torch.equal(s[0], w[0]) and torch.equal(s[1], w[1])
    assert torch.equal(tfft.irfft2(*s, device="cpu"), q.execute_inverse(*w))


def test_fft2_helpers_reject_1d_operands():
    v = torch.zeros(64)
    for fn in (lambda: tfft.fft2(v, v, device="cpu"),
               lambda: tfft.ifft2(v, v, device="cpu"),
               lambda: tfft.rfft2(v, device="cpu"),
               lambda: tfft.irfft2(v, v, device="cpu")):
        with pytest.raises(ValueError, match="trailing TWO axes"):
            fn()


def test_fft3_local(rng):
    xr, xi = _planes(rng, (8, 16, 32))
    p = tfft.plan(kind="c2c", shape=(8, 16, 32), device="cpu")
    yr, yi = p.execute(xr, xi)
    assert _rel_err((yr, yi), np.fft.fftn(xr + 1j * xi)) < TOL


def test_fft_conv2d_matches_direct(rng):
    x = rng.standard_normal((2, 24, 30)).astype(np.float32)
    k = rng.standard_normal((5, 7)).astype(np.float32)
    got = spectral.fft_conv2d(x, k, device="cpu").numpy()
    # direct full 2-D convolution, cropped to the leading h x w window
    want = np.zeros_like(x)
    h, w = x.shape[-2:]
    for b in range(x.shape[0]):
        full = np.zeros((h + 4, w + 6), np.float64)
        for i in range(5):
            for j in range(7):
                full[i:i + h, j:j + w] += k[i, j] * x[b].astype(np.float64)
        want[b] = full[:h, :w]
    assert _rel(got, want) < TOL


# ---------------------------------------------------------------------------
# parity with the JAX package


def _axes(shape):
    return tuple(range(-len(shape), 0))


@pytest.mark.parametrize("shape,batch", [((8, 16), (2,)), ((4, 8, 32), ()),
                                         ((32, 64), (3,)), ((16, 8, 4), (2,)),
                                         ((8192, 4), ())])
@pytest.mark.parametrize("impl", ["matfft", "ref", "stockham"])
def test_c2c_matches_reference_plan(rng, shape, batch, impl):
    """c2c forward and inverse in 2-D and 3-D; (8192, 4) runs its leading
    axis past the port's MAX_LEAF (transposes around a level-1 pass)
    where the reference runs one column pass."""
    x = _planes(rng, (*batch, *shape))
    tp = tfft.plan(kind="c2c", shape=shape, batch_shape=batch, impl=impl,
                   device="cpu")
    jp = jfft.plan(kind="c2c", shape=shape, batch_shape=batch, impl=impl)
    got = tp.execute(*x)
    want = jp.execute(*(jnp.asarray(a) for a in x))
    assert _rel_err(got, want) < TOL
    assert _rel_err(got, np.fft.fftn(x[0] + 1j * x[1], axes=_axes(shape))) \
        < TOL
    back = tp.execute_inverse(*got)
    want_back = jp.execute_inverse(*want)
    assert _rel_err(back, want_back) < TOL
    assert _rel_err(back, x) < TOL
    if len(shape) == 2:  # the helpers run the same plan
        y = tfft.fft2(*x, impl=impl, device="cpu")
        assert torch.equal(y[0], got[0]) and torch.equal(y[1], got[1])
        b = tfft.ifft2(*y, impl=impl, device="cpu")
        assert torch.equal(b[0], back[0]) and torch.equal(b[1], back[1])


@pytest.mark.parametrize("shape,batch", [((8, 16), (2,)), ((4, 8, 32), ()),
                                         ((16, 2), (3,)), ((8, 4, 4), (2,)),
                                         ((8192, 8), ()), ((4, 16384), ())])
@pytest.mark.parametrize("impl", ["matfft", "ref", "stockham"])
def test_r2c_matches_reference_plan(rng, shape, batch, impl):
    """r2c forward and inverse in 2-D and 3-D. impl "ref"/"stockham" and
    a contiguous axis below 4 take the legacy c2c-then-slice forward and
    transpose inverse; (8192, 8) has a leading axis past MAX_LEAF and
    (4, 16384) a level-1 packed half transform."""
    x = rng.standard_normal((*batch, *shape)).astype(np.float32)
    tp = tfft.plan(kind="r2c", shape=shape, batch_shape=batch, impl=impl,
                   device="cpu")
    jp = jfft.plan(kind="r2c", shape=shape, batch_shape=batch, impl=impl)
    got = tp.execute_real(x)
    want = jp.execute_real(jnp.asarray(x))
    assert tuple(got[0].shape) == (*batch, *shape[:-1], shape[-1] // 2 + 1)
    assert _rel_err(got, want) < TOL
    assert _rel_err(got, np.fft.rfftn(x, axes=_axes(shape))) < TOL
    back = tp.execute_inverse(*got)
    want_back = np.asarray(jp.execute_inverse(*want))
    assert tuple(back.shape) == x.shape
    assert _rel(back, want_back) < TOL and _rel(back, x) < TOL
    if len(shape) == 2:  # the helpers run the same plan
        y = tfft.rfft2(x, impl=impl, device="cpu")
        assert torch.equal(y[0], got[0]) and torch.equal(y[1], got[1])
        assert torch.equal(tfft.irfft2(*y, impl=impl, device="cpu"), back)


@pytest.mark.parametrize("impl", ["matfft", "ref", "stockham"])
def test_fft_conv2d_matches_reference(rng, impl):
    x = rng.standard_normal((2, 20, 13)).astype(np.float32)
    k = rng.standard_normal((9, 4)).astype(np.float32)
    got = spectral.fft_conv2d(x, k, impl=impl, device="cpu").numpy()
    want = np.asarray(jspectral.fft_conv2d(jnp.asarray(x), jnp.asarray(k),
                                           impl=impl))
    assert got.shape == x.shape
    assert _rel(got, want) < TOL


def test_untangle_nd_is_not_the_1d_untangle(rng):
    """The N-D partner is flipped along every axis: the 1-D untangle
    applied row by row gives a wrong 2-D spectrum (the failure that
    passes at nd = 1)."""
    x = rng.standard_normal((8, 16)).astype(np.float32)
    zr, zi = executors.fftn(*_t(x[:, 0::2], x[:, 1::2]), (8, 8))
    vr, vi = km.rfft_twiddle(16, torch.device("cpu"))
    good = executors._untangle_nd(zr, zi, vr, vi, 2)
    assert _rel_err(good, np.fft.rfft2(x)) < TOL
    bad = km.untangle_half_spectrum(zr, zi, vr, vi)
    assert _rel_err(bad, np.fft.rfft2(x)) > 1e-2


@pytest.mark.parametrize("shape", [(8, 16), (4, 8, 32)])
def test_entangle_nd_inverts_untangle_nd(rng, shape):
    """irfftn's re-entangle maps the one-sided bins back to the packed
    half spectrum that `_untangle_nd` widened."""
    half = (2, *shape[:-1], shape[-1] // 2)
    zr, zi = _t(*_planes(rng, half))
    vr, vi = km.rfft_twiddle(shape[-1], torch.device("cpu"))
    y = executors._untangle_nd(zr, zi, vr, vi, len(shape))
    back = executors._entangle_nd(*y, shape[-1], len(shape))
    assert _rel_err(back, (zr.numpy(), zi.numpy())) < TOL


# ---------------------------------------------------------------------------
# the zero-copy chain: one K2 pass per earlier axis, no transposed copy


def test_wrappers_record_each_calls_shape(rng):
    """Each wrapper records (wrapper, shape, out_major) of a call it gives
    to its plain version; the card's launches go to `launch_shapes`, and
    `reset_counts` clears both."""
    from collections import Counter
    x = _t(*_planes(rng, (2, 64, 128)))
    km.reset_counts()
    tfft.fft2(*x, device="cpu")
    executors.rfftn(x[0], (64, 128))
    assert km.plain_shapes == Counter({
        ("matfft", (128, 128), None): 1,
        ("matfft_cols", (2, 64, 128), "col"): 1,
        ("rfft_pack_leaf", (128, 128), None): 1,
        ("matfft_cols", (2, 64, 64), "col"): 1})
    assert not km.launch_shapes
    km.reset_counts()
    assert not km.plain_shapes


class _CopyRecorder(TorchDispatchMode):
    """Records the aten ops that materialize a tensor copy, outside the
    kernels' plain versions (which transpose on the CPU where the kernels
    read strided)."""

    COPIES = ("clone", "copy_", "_to_copy")

    def __init__(self):
        super().__init__()
        self.copies, self.paused = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and func.overloadpacket.__name__ in self.COPIES:
            self.copies.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def copies(monkeypatch):
    rec = _CopyRecorder()
    for name in ("matfft_plain", "matfft_cols_plain",
                 "rfft_pack_leaf_plain"):
        plain = getattr(km, name)

        def paused(*a, _plain=plain, **kw):
            rec.paused += 1
            try:
                return _plain(*a, **kw)
            finally:
                rec.paused -= 1
        monkeypatch.setattr(km, name, paused)
    return rec


@pytest.mark.parametrize("shape", [(64, 128), (8, 16, 32)])
def test_fftn_zero_copy_is_transpose_free(rng, copies, shape):
    x = _t(*_planes(rng, (2, *shape)))
    for layout in ("zero_copy", "copy"):
        km.reset_counts()
        copies.copies.clear()
        with copies:
            executors.fftn(*x, shape, layout=layout)
        if layout == "zero_copy":
            # one K1 pass on the contiguous axis, one K2 pass per axis
            assert km.matfft_plain.calls == 1
            assert km.matfft_cols_plain.calls == len(shape) - 1
            assert copies.copies == []
        else:  # the naive baseline materializes its transposes
            assert km.matfft_cols_plain.calls == 0
            assert len(copies.copies) >= 2 * (len(shape) - 1)

    x = torch.from_numpy(rng.standard_normal((2, *shape)).astype(np.float32))
    km.reset_counts()
    copies.copies.clear()
    with copies:
        executors.rfftn(x, shape)
    assert km.rfft_pack_leaf_plain.calls == 1
    assert km.matfft_cols_plain.calls == len(shape) - 1
    assert copies.copies == []


@pytest.mark.parametrize("shape", [(64, 128), (8, 16, 32), (16, 1 << 15),
                                   (8192, 8)])
def test_zero_copy_equals_copy_bitwise(rng, shape):
    """bench_fft2.py's zero_copy_bitwise_vs_naive gate, inside the port:
    the K2 column passes against K1 over materialized transposes."""
    x = _t(*_planes(rng, (2, *shape)))
    zc = tfft.fft2(*x, device="cpu") if len(shape) == 2 else \
        executors.fftn(*x, shape)
    cp = tfft.fft2(*x, device="cpu", layout="copy") if len(shape) == 2 \
        else executors.fftn(*x, shape, layout="copy")
    assert torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])
    r = x[0]
    zc = executors.rfftn(r, shape)
    cp = executors.rfftn(r, shape, layout="copy")
    assert torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])
    if len(shape) == 2:
        w = tfft.rfft2(r, device="cpu", layout="copy")
        assert torch.equal(w[0], cp[0]) and torch.equal(w[1], cp[1])


def test_nd_plans_run_where_they_were_planned(monkeypatch):
    """No N-D plan falls back to the CPU: without a card the default
    device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfft.plan(kind="c2c", shape=(64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfft.rfft2(np.zeros((8, 8), np.float32))
