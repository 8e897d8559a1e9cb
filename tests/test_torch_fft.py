"""The port's plan-and-execute facade (`repro_torch.fft`) against the JAX
package's (`repro.fft`), on the CPU through the kernels' plain versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.fft as jfft
import repro_torch.fft as tfft
from repro_torch.fft import executors
from repro_torch.kernels.fft import matfft as km
from repro_torch.kernels.fft import plan as tplan

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


@pytest.mark.parametrize("n,rows", [(1024, 3), (1 << 15, 2)])
def test_execute_and_inverse_match_reference_plan(rng, n, rows):
    """The selftest's c2c/leaf (n=1024) and c2c/four_step (n=2^15) cases:
    the port's n=2^15 runs one level deeper than the reference (its
    MAX_LEAF is smaller), so outputs are compared, not plan structure."""
    x = _planes(rng, (rows, n))
    tp = tfft.plan(kind="c2c", n=n, batch_shape=(rows,), device="cpu")
    jp = jfft.plan(kind="c2c", n=n, batch_shape=(rows,))
    got = tp.execute(*x)
    want = jp.execute(*(jnp.asarray(a) for a in x))
    assert _rel_err(got, want) < TOL
    back = tp.execute_inverse(*got)
    want_back = jp.execute_inverse(*want)
    assert _rel_err(back, want_back) < TOL
    assert _rel_err(back, x) < TOL


def test_zero_builds_on_repeat_execute(rng):
    """The cufftPlanMany property: repeat executes on an identical spec
    reuse the built plan — its build count stays at 1."""
    tfft.clear_plan_cache()
    p = tfft.plan(kind="c2c", n=512, batch_shape=(2,), device="cpu")
    x = _planes(rng, (2, 512))
    p.execute(*x)
    assert p.build_counts["forward"] == 1
    p.execute(*x)
    p.execute(x[0] + 1.0, x[1])  # new values, same shape: no rebuild
    assert p.build_counts["forward"] == 1
    p2 = tfft.plan(kind="c2c", n=512, batch_shape=(2,), device="cpu")
    p2.execute(*x)
    assert p2 is p and p.build_counts["forward"] == 1
    assert tfft.cache_info()["hits"] == 1


def test_execute_async_donate_zero_builds_on_repeat(rng):
    tfft.clear_plan_cache()
    p = tfft.plan(kind="c2c", n=256, batch_shape=(3,), device="cpu")
    for _ in range(3):
        xr, xi = _planes(rng, (3, 256))
        got = p.execute_async(torch.from_numpy(xr), torch.from_numpy(xi),
                              donate=True).realize()
        want = np.fft.fft(xr.astype(np.float64) + 1j * xi)
        assert _rel_err(got, (want.real, want.imag)) < TOL
    assert p.build_counts == {"forward": 1, "inverse": 0}


def test_execute_async_matches_execute(rng):
    p = tfft.plan(kind="c2c", n=256, batch_shape=(4,), device="cpu")
    x = _planes(rng, (4, 256))
    want = p.execute(*x)
    got_r, got_i = p.execute_async(*x).realize()
    np.testing.assert_array_equal(want[0].numpy(), got_r)
    np.testing.assert_array_equal(want[1].numpy(), got_i)
    with pytest.raises(ValueError, match="2 operand"):
        p.execute_async(x[0])


def test_cache_identity_and_misses():
    tfft.clear_plan_cache()
    p1 = tfft.plan(kind="c2c", n=256, batch_shape=(3,), device="cpu")
    assert tfft.plan(kind="c2c", n=256, batch_shape=(3,), device="cpu") is p1
    assert tfft.plan(kind="c2c", shape=(256,), batch_shape=(3,),
                     device="cpu") is p1
    for kw in (dict(layout="copy"), dict(impl="ref"), dict(verify="abft"),
               dict(batch_shape=(4,))):
        args = {"kind": "c2c", "n": 256, "batch_shape": (3,),
                "device": "cpu", **kw}
        assert tfft.plan(**args) is not p1
    info = tfft.cache_info()
    assert (info["hits"], info["misses"], info["entries"]) == (2, 5, 5)


def test_plan_is_frozen_and_checks_shapes(rng):
    p = tfft.plan(kind="c2c", n=64, batch_shape=(1,), device="cpu")
    with pytest.raises(AttributeError, match="frozen"):
        p.spec = None
    with pytest.raises(ValueError, match="built for shape"):
        p.execute(*_planes(rng, (2, 64)))
    with pytest.raises(TypeError, match="float32"):
        p.execute(np.zeros((1, 64)), np.zeros((1, 64)))


def test_cost_model_matches_reference(rng):
    for n in (1024, 1 << 15):
        tp = tfft.plan(kind="c2c", n=n, batch_shape=(8,), device="cpu")
        jp = jfft.plan(kind="c2c", n=n, batch_shape=(8,))
        assert tp.flops == jp.flops
        assert tp.levels == (1 if n <= 4096 else 2)
        assert tp.hbm_bytes == 8 * (16 if tp.levels == 1 else 32) * n


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfft.plan(kind="c2c", n=256, batch_shape=(2,))


def test_stockham_waits_for_its_kernel(rng):
    """impl="stockham" runs kernel K4 (here its plain version) and agrees
    with the reference's stockham plan."""
    x = _planes(rng, (2, 256))
    p = tfft.plan(kind="c2c", n=256, batch_shape=(2,), impl="stockham",
                  device="cpu")
    km.reset_counts()
    got = p.execute(*x)
    assert km.matfft_plain.calls == 0
    jp = jfft.plan(kind="c2c", n=256, batch_shape=(2,), impl="stockham")
    want = jp.execute(*(jnp.asarray(a) for a in x))
    assert _rel_err(got, want) < TOL
    assert _rel_err(p.execute_inverse(*got), x) < TOL


def test_ref_impl_matches_matfft(rng):
    x = _planes(rng, (2, 8192))
    a = tfft.plan(kind="c2c", n=8192, batch_shape=(2,), device="cpu")
    b = tfft.plan(kind="c2c", n=8192, batch_shape=(2,), impl="ref",
                  device="cpu")
    assert _rel_err(a.execute(*x), b.execute(*x)) < TOL


# ---------------------------------------------------------------------------
# level 1: the zero-copy four-step


@pytest.mark.parametrize("n", [8192, 1 << 15, 1 << 16])
def test_zero_copy_equals_copy_bitwise(rng, n):
    x = tuple(torch.from_numpy(a) for a in _planes(rng, (2, n)))
    zc = executors.fft(*x, layout="zero_copy")
    cp = executors.fft(*x, layout="copy")
    assert torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])


def test_zero_copy_passes_run_the_column_kernel_only(rng):
    """Both level-1 passes go through K2 (no row-major leaf call and no
    transposed copy in between), the port's analogue of
    test_no_transpose_between_leaf_passes."""
    km.reset_counts()
    x = tuple(torch.from_numpy(a) for a in _planes(rng, (2, 1 << 15)))
    executors.fft(*x)
    assert km.matfft_cols_plain.calls == 2
    assert km.matfft_plain.calls == 0


@pytest.fixture
def leaf16(monkeypatch):
    """Cap the port's leaf at 16 points, so that n = 1024 plans three
    levels as n > 2^24 does at the real cap; plans built under the cap
    leave the cache with it."""
    make_plan = tplan.make_plan
    monkeypatch.setattr(tplan, "make_plan",
                        lambda n, max_leaf=16: make_plan(n, max_leaf))
    tfft.clear_plan_cache()
    yield
    tfft.clear_plan_cache()


def test_three_levels_match_reference(rng, leaf16):
    x = _planes(rng, (2, 1024))
    tp = tfft.plan(kind="c2c", n=1024, batch_shape=(2,), device="cpu")
    assert tp.levels == 3
    jp = jfft.plan(kind="c2c", n=1024, batch_shape=(2,))
    km.reset_counts()
    got = tp.execute(*x)
    # pass 1 and the level-2 second pass's two passes, all through K2
    assert (km.matfft_cols_plain.calls, km.matfft_plain.calls) == (3, 0)
    want = jp.execute(*(jnp.asarray(a) for a in x))
    assert _rel_err(got, want) < TOL
    assert _rel_err(tp.execute_inverse(*got), x) < TOL
    cp = executors.fft(*(torch.from_numpy(a) for a in x), layout="copy")
    assert torch.equal(got[0], cp[0]) and torch.equal(got[1], cp[1])


@pytest.mark.parametrize("out_major", ["row", "col"])
def test_fft_cols_matches_reference(rng, out_major):
    from repro.fft import executors as jex
    x = _planes(rng, (256, 32))
    got = executors.fft_cols(*(torch.from_numpy(a) for a in x),
                             out_major=out_major)
    want = jex.fft_cols(*(jnp.asarray(a) for a in x), out_major=out_major,
                        interpret=True)
    assert tuple(got[0].shape) == tuple(want[0].shape)
    assert _rel_err(got, want) < TOL


def test_ifft_conjugation_identity(rng):
    x = tuple(torch.from_numpy(a) for a in _planes(rng, (3, 2048)))
    back = executors.ifft(*executors.fft(*x))
    assert _rel_err(back, x) < TOL
