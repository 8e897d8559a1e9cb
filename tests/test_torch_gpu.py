"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA card (decided in
the ``cuda`` fixture). This file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fft import matfft as km
from repro_torch.kernels.fft import plan as tplan

TOL = 5e-6  # max|kernel - plain| / max|plain|


def _rel_err(got, want) -> float:
    g = got[0].double().cpu() + 1j * got[1].double().cpu()
    w = want[0].double().cpu() + 1j * want[1].double().cpu()
    return float((g - w).abs().max() / (w.abs().max() or 1.0))


def _planes(rng, shape, device):
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)).to(device)
                 for _ in range(2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 16, 256, 512, 1024, 2048,
                               tplan.MAX_LEAF])
@pytest.mark.parametrize("rows", [1, 7, 300])
def test_k1_kernel_matches_plain(cuda, rng, n, rows):
    x = _planes(rng, (rows, n), cuda)
    epi = _planes(rng, (4, n), cuda)
    for e in (None, epi):
        before = km.matfft.launches
        got = km.matfft(*x, epilogue=e)
        assert km.matfft.launches == before + 1
        want = km.matfft_plain(*x, epilogue=e)
        assert _rel_err(got, want) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("L,C", [(2, 2), (16, 1024), (256, 8), (1024, 16),
                                 (tplan.MAX_LEAF, 4)])
@pytest.mark.parametrize("out_major", ["row", "col"])
def test_k2_kernel_matches_plain(cuda, rng, L, C, out_major):
    x = _planes(rng, (3, L, C), cuda)
    epi = _planes(rng, (C, L), cuda)
    for e in (None, epi):
        got = km.matfft_cols(*x, out_major=out_major, epilogue=e)
        want = km.matfft_cols_plain(*x, out_major=out_major, epilogue=e)
        assert _rel_err(got, want) < TOL


@pytest.mark.gpu
def test_k1_kernel_rows_are_batch_invariant(cuda, rng):
    x = _planes(rng, (4096, 1024), cuda)
    alone = km.matfft(x[0][5:6].contiguous(), x[1][5:6].contiguous())
    batch = km.matfft(*x)
    assert torch.equal(alone[0][0], batch[0][5])
    assert torch.equal(alone[1][0], batch[1][5])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 1024, 1 << 15, 1 << 20, 1 << 25])
def test_plan_on_the_card_matches_the_cpu_plan(cuda, rng, n):
    import repro_torch.fft as tfft
    rows = max(2, (1 << 18) // n)
    x = _planes(rng, (rows, n), "cpu")
    on_card = tfft.plan(kind="c2c", n=n, batch_shape=(rows,))
    on_cpu = tfft.plan(kind="c2c", n=n, batch_shape=(rows,), device="cpu")
    got = on_card.execute(*x)
    assert got[0].device.type == "cuda"
    assert _rel_err(got, on_cpu.execute(*x)) < TOL
    back = on_card.execute_inverse(*got)
    assert _rel_err(back, x) < TOL
    assert on_card.build_counts == {"forward": 1, "inverse": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 13, 1 << 16, 1 << 25])
def test_zero_copy_equals_copy_bitwise_on_the_card(cuda, rng, n):
    """K2's column passes and K1's row passes over materialized transposes
    give each row the same result, bit for bit."""
    from repro_torch.fft import executors
    x = _planes(rng, (4, n), cuda)
    zc = executors.fft(*x, layout="zero_copy")
    cp = executors.fft(*x, layout="copy")
    assert torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])


@pytest.mark.gpu
@pytest.mark.parametrize("donate", [False, True])
def test_execute_async_from_pinned_staging(cuda, rng, donate):
    import repro_torch.fft as tfft
    p = tfft.plan(kind="c2c", n=1024, batch_shape=(64,))
    x = tuple(t.pin_memory() for t in _planes(rng, (64, 1024), "cpu"))
    got = p.execute_async(*x, donate=donate).realize()
    want = p.execute(*x)
    np.testing.assert_array_equal(got[0], want[0].cpu().numpy())
    np.testing.assert_array_equal(got[1], want[1].cpu().numpy())
