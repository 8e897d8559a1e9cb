"""The port's 1-D real-input plans (`plan(kind="r2c")`) against the JAX
package's, on the CPU through the kernels' plain versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.fft as jfft
import repro_torch.fft as tfft
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


def _real(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n,rows", [(8, 5), (1024, 3), (8192, 2),
                                    (1 << 14, 2)])
def test_execute_real_and_inverse_match_reference_plan(rng, n, rows):
    """The selftest's r2c/leaf case (n=1024) and lengths on both sides of
    the port's fused range: at 2^14 the reference fuses the untangle in
    its leaf, the port runs it after a level-1 half transform."""
    x = _real(rng, (rows, n))
    tp = tfft.plan(kind="r2c", n=n, batch_shape=(rows,), device="cpu")
    jp = jfft.plan(kind="r2c", n=n, batch_shape=(rows,))
    got = tp.execute_real(x)
    want = jp.execute_real(jnp.asarray(x))
    assert tuple(got[0].shape) == (rows, n // 2 + 1)
    assert _rel_err(got, want) < TOL
    back = tp.execute_inverse(*got)
    want_back = np.asarray(jp.execute_inverse(*want))
    assert tuple(back.shape) == (rows, n)
    assert np.abs(back.numpy() - want_back).max() / np.abs(x).max() < TOL
    assert np.abs(back.numpy() - x).max() / np.abs(x).max() < TOL
    assert tp.flops == jp.flops


@pytest.mark.parametrize("n,fused", [(8, True), (4096, True), (8192, True),
                                     (1 << 14, False)])
def test_fused_untangle_and_hbm_bytes(n, fused):
    p = tfft.plan(kind="r2c", n=n, batch_shape=(4,), device="cpu")
    assert p.fused_untangle is fused
    assert p.levels == (1 if fused else 2)
    assert p.hbm_bytes_per_row == tplan.rfft_hbm_bytes(n)
    assert p.hbm_bytes == 4 * tplan.rfft_hbm_bytes(n)
    if fused:  # read the real row, write the one-sided spectrum
        assert p.hbm_bytes_per_row == 4 * n + 8 * (n // 2 + 1)
    m = n // 2  # a half-length transform plus the untangle
    assert p.flops == 4 * (5.0 * m * np.log2(m) + 10.0 * m)
    assert not tfft.plan(kind="c2c", n=n, batch_shape=(4,),
                         device="cpu").fused_untangle


def test_execute_async_takes_one_operand(rng):
    p = tfft.plan(kind="r2c", n=512, batch_shape=(3,), device="cpu")
    x = torch.from_numpy(_real(rng, (3, 512)))
    want = p.execute_real(x)
    for donate in (False, True):
        got = p.execute_async(x, donate=donate).realize()
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
    with pytest.raises(ValueError, match="1 operand"):
        p.execute_async(x, x)
    assert p.build_counts == {"forward": 1, "inverse": 0}


def test_execute_and_execute_real_refuse_the_other_kind(rng):
    r = tfft.plan(kind="r2c", n=64, batch_shape=(2,), device="cpu")
    c = tfft.plan(kind="c2c", n=64, batch_shape=(2,), device="cpu")
    x = _real(rng, (2, 64))
    with pytest.raises(ValueError, match=r"use execute_real\(x\)"):
        r.execute(x, x)
    with pytest.raises(ValueError, match=r"use execute\(xr, xi\)"):
        c.execute_real(x)
    with pytest.raises(ValueError, match="built for shape"):
        r.execute_real(_real(rng, (2, 32)))
    with pytest.raises(ValueError, match="built for shape"):
        r.execute_inverse(*(_real(rng, (2, 64)),) * 2)


@pytest.mark.parametrize("impl", ["stockham", "ref"])
def test_r2c_with_other_leaves_takes_the_full_transform(rng, impl):
    x = _real(rng, (3, 256))
    p = tfft.plan(kind="r2c", n=256, batch_shape=(3,), impl=impl,
                  device="cpu")
    assert not p.fused_untangle and p.levels == 1
    assert p.hbm_bytes_per_row == (tplan.fft_hbm_bytes(256)
                                   + 8 * (256 // 2 + 1))
    km.reset_counts()
    got = p.execute_real(x)
    assert km.rfft_leaf_plain.calls == 0
    want = np.fft.rfft(x.astype(np.float64))
    assert _rel_err(got, (want.real, want.imag)) < TOL
    back = p.execute_inverse(*got)
    assert np.abs(back.numpy() - x).max() / np.abs(x).max() < TOL


def test_r2c_builds_once_and_keys_its_own_cache_entry(rng):
    tfft.clear_plan_cache()
    p = tfft.plan(kind="r2c", n=256, batch_shape=(2,), device="cpu")
    assert tfft.plan(kind="r2c", n=256, batch_shape=(2,), device="cpu") is p
    assert tfft.plan(kind="c2c", n=256, batch_shape=(2,), device="cpu") \
        is not p
    x = _real(rng, (2, 256))
    for _ in range(3):
        p.execute_inverse(*p.execute_real(x))
    assert p.build_counts == {"forward": 1, "inverse": 1}
    assert "fused_untangle=True" in repr(p)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(n=1), ValueError, "n >= 2"),
    (dict(shape=(64, 64), r2c_axis=0), ValueError, "contiguous axis"),
])
def test_r2c_specs_the_port_refuses(kw, exc, match):
    with pytest.raises(exc, match=match):
        tfft.plan(kind="r2c", device="cpu", **kw)
