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
from repro_torch.kernels.fft import stockham as ks

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


LEAF_NS = [1 << p for p in range(13)]  # every leaf length, 1 to MAX_LEAF


@pytest.mark.gpu
@pytest.mark.parametrize("n", LEAF_NS)
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
@pytest.mark.parametrize("L,C", [(2, 2), (16, 1024), (32, 1), (64, 64),
                                 (128, 2), (256, 8), (256, 256), (512, 1),
                                 (1024, 16), (2048, 8), (tplan.MAX_LEAF, 4)])
@pytest.mark.parametrize("out_major", ["row", "col"])
def test_k2_kernel_matches_plain(cuda, rng, L, C, out_major):
    x = _planes(rng, (3, L, C), cuda)
    epi = _planes(rng, (C, L), cuda)
    for e in (None, epi):
        got = km.matfft_cols(*x, out_major=out_major, epilogue=e)
        want = km.matfft_cols_plain(*x, out_major=out_major, epilogue=e)
        assert _rel_err(got, want) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 1024, 2048, 4096])
def test_k1_kernel_rows_are_batch_invariant(cuda, rng, n):
    x = _planes(rng, (4096, n), cuda)
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
@pytest.mark.parametrize("n", [1 << 13, 1 << 16, 1 << 17, 1 << 20, 1 << 22,
                               1 << 24, 1 << 25])
def test_zero_copy_equals_copy_bitwise_on_the_card(cuda, rng, n):
    """K2's column passes and K1's row passes over materialized transposes
    give each row the same result, bit for bit."""
    from repro_torch.fft import executors
    x = _planes(rng, (4, n), cuda)
    zc = executors.fft(*x, layout="zero_copy")
    cp = executors.fft(*x, layout="copy")
    assert torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                               4096, 2 * tplan.MAX_LEAF])
@pytest.mark.parametrize("rows", [1, 7, 300])
def test_k3_kernel_matches_plain(cuda, rng, n, rows):
    x = torch.from_numpy(rng.standard_normal((rows, n))
                         .astype(np.float32)).to(cuda)
    for kernel, plain in ((km.rfft_leaf, km.rfft_leaf_plain),
                          (km.rfft_pack_leaf, km.rfft_pack_leaf_plain)):
        before = kernel.launches
        got = kernel(x)
        assert kernel.launches == before + 1
        want = plain(x)
        assert got[0].shape == want[0].shape
        assert _rel_err(got, want) < TOL
    full = torch.fft.rfft(x.double(), dim=-1)
    assert _rel_err(km.rfft_leaf(x), (full.real, full.imag)) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("n", LEAF_NS)
def test_radix_kernels_equal_their_plain_versions_bitwise(cuda, rng, n):
    """The radix leaf rounds every sum and product as its plain version
    does, in the same order: K1, K2 (both majors, with the epilogue, with
    a full tile of columns and with fewer) and K3 (n = 2 * that length)
    give the plain versions' bits."""
    def same(got, want):
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    x = _planes(rng, (300, n), cuda)
    epi = _planes(rng, (4, n), cuda)
    assert same(km.matfft(*x, epilogue=epi), km.matfft_plain(*x, epilogue=epi))
    for C in (64, 2):
        x3 = _planes(rng, (3, n, C), cuda)
        epi3 = _planes(rng, (C, n), cuda)
        for major in ("row", "col"):
            assert same(
                km.matfft_cols(*x3, out_major=major, epilogue=epi3),
                km.matfft_cols_plain(*x3, out_major=major, epilogue=epi3))
    if n >= 2:
        xr = torch.from_numpy(rng.standard_normal((300, 2 * n))
                              .astype(np.float32)).to(cuda)
        assert same(km.rfft_leaf(xr), km.rfft_leaf_plain(xr))
        assert same(km.rfft_pack_leaf(xr), km.rfft_pack_leaf_plain(xr))


@pytest.mark.gpu
@pytest.mark.parametrize("n", LEAF_NS)
@pytest.mark.parametrize("rows", [1, 7, 300])
def test_k4_kernel_matches_plain(cuda, rng, n, rows):
    """K4 runs the plain version's butterflies, rounded the same way, in
    groups of up to four stages: every split of the groups gives the plain
    version's bits."""
    x = _planes(rng, (rows, n), cuda)
    before = ks.stockham_fft.launches
    got = ks.stockham_fft(*x)
    assert ks.stockham_fft.launches == before + (n > 1)
    want = ks.stockham_fft_plain(*x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    full = torch.fft.fft(torch.complex(*x).to(torch.complex128), dim=-1)
    assert _rel_err(got, (full.real, full.imag)) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
def test_k3_and_k4_rows_are_batch_invariant(cuda, rng, n):
    x = torch.from_numpy(rng.standard_normal((4096, n))
                         .astype(np.float32)).to(cuda)
    for fn in (km.rfft_leaf, km.rfft_pack_leaf):
        alone = fn(x[5:6].contiguous())
        batch = fn(x)
        assert torch.equal(alone[0][0], batch[0][5])
        assert torch.equal(alone[1][0], batch[1][5])
    xr, xi = _planes(rng, (4096, n), cuda)
    alone = ks.stockham_fft(xr[5:6].contiguous(), xi[5:6].contiguous())
    batch = ks.stockham_fft(xr, xi)
    assert torch.equal(alone[0][0], batch[0][5])
    assert torch.equal(alone[1][0], batch[1][5])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 1024, 8192, 1 << 14, 1 << 20])
def test_r2c_plan_on_the_card_matches_the_cpu_plan(cuda, rng, n):
    import repro_torch.fft as tfft
    rows = max(2, (1 << 18) // n)
    x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
    on_card = tfft.plan(kind="r2c", n=n, batch_shape=(rows,))
    on_cpu = tfft.plan(kind="r2c", n=n, batch_shape=(rows,), device="cpu")
    got = on_card.execute_real(x)
    assert _rel_err(got, on_cpu.execute_real(x)) < TOL
    back = on_card.execute_inverse(*got)
    assert float((back.cpu() - x).abs().max() / x.abs().max()) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 1 << 20])
def test_stockham_plan_on_the_card_launches_k4(cuda, rng, n):
    import repro_torch.fft as tfft
    rows = max(2, (1 << 18) // n)
    x = _planes(rng, (rows, n), "cpu")
    ks.reset_counts()
    got = tfft.plan(kind="c2c", n=n, batch_shape=(rows,),
                    impl="stockham").execute(*x)
    assert ks.stockham_fft.launches == (1 if n <= tplan.MAX_LEAF else 2)
    assert ks.stockham_fft_plain.calls == 0
    full = torch.fft.fft(torch.complex(*x).to(torch.complex128), dim=-1)
    assert _rel_err(got, (full.real, full.imag)) < TOL


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


@pytest.mark.gpu
def test_async_clocks_and_spans_on_the_card(cuda, rng, tmp_path):
    """A realized call's device time and copy time, and its spans on both
    timelines of a CUDA trace: the host's user annotations and their
    copies on the device's."""
    import json

    from torch.profiler import ProfilerActivity, profile

    import repro_torch.fft as tfft
    p = tfft.plan(kind="c2c", n=1024, batch_shape=(4096,))
    x = tuple(t.pin_memory() for t in _planes(rng, (4096, 1024), "cpu"))
    h = p.execute_async(*x, donate=True)
    assert h.device_ms is None   # not realized yet
    h.realize()
    assert h.device_ms > 0 and h.copy_s > 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p.execute_async(*x, donate=True).realize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {c: {e["name"] for e in events if e.get("cat") == c}
             for c in ("user_annotation", "gpu_user_annotation")}
    fft = "repro_torch.fft."
    assert {fft + s for s in ("execute_async", "rows", "realize",
                              "realize.wait", "realize.copy")} \
        <= names["user_annotation"]
    assert fft + "execute_async" in names["gpu_user_annotation"]


# N-D plans: (shape, batch) pairs at 2^18 to 2^20 points, with a K1 or K3
# contiguous axis, K2 earlier axes, a level-1 contiguous axis and a
# leading axis past MAX_LEAF (transposes around two K2 passes)
ND_SHAPES = [((64, 64), (16,)), ((512, 1024), ()), ((16, 1 << 15), ()),
             ((8192, 64), ()), ((64, 128, 32), (2,)), ((8, 16, 4096), ())]


def _axis_k2_launches(shape) -> int:
    """K2 launches of the earlier axes of an N-D forward: one column pass
    an axis up to MAX_LEAF, the two passes of the level-1 four-step (between
    transposes) past it."""
    return sum(1 if n <= tplan.MAX_LEAF else 2 for n in shape[:-1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,batch", ND_SHAPES)
def test_fftn_plan_on_the_card_matches_the_cpu_plan(cuda, rng, shape, batch):
    import repro_torch.fft as tfft
    x = _planes(rng, (*batch, *shape), "cpu")
    km.reset_counts()
    on_card = tfft.plan(kind="c2c", shape=shape, batch_shape=batch)
    got = on_card.execute(*x)
    # the contiguous axis: one K1 pass, or the level-1 four-step's two K2
    leaf = shape[-1] <= tplan.MAX_LEAF
    assert km.matfft.launches == int(leaf)
    assert km.matfft_cols.launches == (2 * (not leaf)
                                       + _axis_k2_launches(shape))
    assert km.matfft_cols_plain.calls == km.matfft_plain.calls == 0
    on_cpu = tfft.plan(kind="c2c", shape=shape, batch_shape=batch,
                       device="cpu")
    assert _rel_err(got, on_cpu.execute(*x)) < TOL
    assert _rel_err(on_card.execute_inverse(*got), x) < TOL
    if len(shape) == 2:  # the helper is the same plan
        y = tfft.fft2(*(t.to(cuda) for t in x))
        assert torch.equal(y[0], got[0]) and torch.equal(y[1], got[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,batch", ND_SHAPES)
def test_rfftn_plan_on_the_card_matches_the_cpu_plan(cuda, rng, shape, batch):
    import repro_torch.fft as tfft
    x = torch.from_numpy(rng.standard_normal((*batch, *shape))
                         .astype(np.float32))
    km.reset_counts()
    on_card = tfft.plan(kind="r2c", shape=shape, batch_shape=batch)
    got = on_card.execute_real(x)
    # the contiguous axis: K3 packed, or the level-1 four-step's two K2 at
    # half length
    leaf = shape[-1] // 2 <= tplan.MAX_LEAF
    assert km.rfft_pack_leaf.launches == int(leaf)
    assert km.matfft.launches == 0
    assert km.matfft_cols.launches == (2 * (not leaf)
                                       + _axis_k2_launches(shape))
    assert km.rfft_pack_leaf_plain.calls == km.matfft_cols_plain.calls == 0
    on_cpu = tfft.plan(kind="r2c", shape=shape, batch_shape=batch,
                       device="cpu")
    assert _rel_err(got, on_cpu.execute_real(x)) < TOL
    back = on_card.execute_inverse(*got)
    assert float((back.cpu() - x).abs().max() / x.abs().max()) < TOL
    if len(shape) == 2:
        y = tfft.rfft2(x.to(cuda))
        assert torch.equal(y[0], got[0]) and torch.equal(y[1], got[1])
        assert torch.equal(tfft.irfft2(*y), back)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 1024), (8192, 64), (64, 128, 32)])
def test_nd_zero_copy_equals_copy_bitwise_on_the_card(cuda, rng, shape):
    from repro_torch.fft import executors
    x = _planes(rng, (2, *shape), cuda)
    zc = executors.fftn(*x, shape)
    cp = executors.fftn(*x, shape, layout="copy")
    assert torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])
    zc = executors.rfftn(x[0], shape)
    cp = executors.rfftn(x[0], shape, layout="copy")
    assert torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])


# the distributed four-step's options: the global twiddle (K1, K2) and
# K2's column slab, bitwise against their plain versions

def _same(got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n", LEAF_NS)
def test_global_twiddle_kernels_equal_their_plain_versions(cuda, rng, n):
    x = _planes(rng, (300, n), cuda)
    for gt in ((1 << 20, 0), (1 << 32, (1 << 31) + 5), (64, 7)):
        assert _same(km.matfft(*x, global_twiddle=gt),
                     km.matfft_plain(*x, global_twiddle=gt))
    x3 = _planes(rng, (3, n, 64), cuda)
    for major in ("row", "col"):
        for off, nc in ((0, 64), (32, 16), (5, 1)):
            got = km.matfft_cols(*x3, out_major=major, global_twiddle=(
                1 << 24, 4096), col_offset=off, ncols=nc)
            want = km.matfft_cols_plain(*x3, out_major=major, global_twiddle=(
                1 << 24, 4096), col_offset=off, ncols=nc)
            assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("major", ["row", "col"])
@pytest.mark.parametrize("off,nc,twiddle", [
    (0, 4096, (1 << 24, 0)), (1024, 1024, None), (4095, 1, None),
    (3072, 1024, (1 << 24, 3072)), (4094, 2, (1 << 24, 4094)),
    (4092, 4, (1 << 24, 4092)), (4088, 8, (1 << 24, 4088))])
def test_distributed_options_at_the_one_card_shapes(cuda, rng, major, off,
                                                    nc, twiddle):
    """chip_smoke.py's shapes at n = 2^24 on one rank: (1, 4096, 4096)."""
    x = _planes(rng, (1, 4096, 4096), cuda)
    before = km.matfft_cols.launches
    got = km.matfft_cols(*x, out_major=major, global_twiddle=twiddle,
                         col_offset=off, ncols=nc)
    assert km.matfft_cols.launches == before + 1
    assert _same(got, km.matfft_cols_plain(
        *x, out_major=major, global_twiddle=twiddle, col_offset=off,
        ncols=nc))


@pytest.mark.gpu
def test_distributed_options_at_the_eight_rank_shapes(cuda, rng):
    """An 8-rank plan at 2^24: pass 1 (1, 4096, 512) with the twiddle at
    each rank's row offset, pass 2 (1, 4096, 512) column-major in slabs of
    128; and K1 with the twiddle, the copy layout's pass 1."""
    x = _planes(rng, (1, 4096, 512), cuda)
    for r in range(8):
        gt = (1 << 24, r * 512)
        assert _same(km.matfft_cols(*x, global_twiddle=gt),
                     km.matfft_cols_plain(*x, global_twiddle=gt))
    for j in range(4):
        kw = dict(out_major="col", col_offset=j * 128, ncols=128)
        assert _same(km.matfft_cols(*x, **kw),
                     km.matfft_cols_plain(*x, **kw))
    rows = _planes(rng, (512, 4096), cuda)
    assert _same(km.matfft(*rows, global_twiddle=(1 << 24, 1536)),
                 km.matfft_plain(*rows, global_twiddle=(1 << 24, 1536)))


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", ["off", 4])
def test_distributed_plan_on_one_card(cuda, rng, tmp_path, overlap):
    """A world-size-1 NCCL group: the exchanges are real NCCL calls that
    move nothing, the passes run K2 with both options."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.fft as tfft
    n = 1 << 20
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    try:
        x = _planes(rng, (n,), cuda)
        want = torch.fft.fft(torch.complex(*x).to(torch.complex128))
        outs = []
        for fuse in (False, True):
            km.reset_counts()
            p = tfft.plan(kind="c2c", n=n, mesh=mesh, placement="distributed",
                          overlap=overlap, fuse_twiddle=fuse)
            y = p.execute(*x)
            assert km.matfft_cols.launches == (2 if overlap == "off" else 8)
            assert km.matfft_cols_plain.calls == 0
            assert _rel_err(y, (want.real, want.imag)) < TOL
            assert _rel_err(p.execute_inverse(*y), x) < TOL
            outs.append(y)
        assert _same(*outs)
    finally:
        tfft.invalidate_mesh(mesh)  # its plans hold the group
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape,dims", [
    ("c2c", (512, 256), (1,)), ("c2c", (8192, 64), (1,)),
    ("c2c", (64, 32, 128), (1, 1)), ("r2c", (512, 256), (1,)),
    ("r2c", (64, 32, 128), (1, 1))])
@pytest.mark.parametrize("overlap", ["off", 4])
def test_pencil_plan_on_one_card(cuda, rng, tmp_path, kind, shape, dims,
                                 overlap):
    """The 2-D and 3-D pencils on a world-size-1 NCCL group, a (1,) or (1,
    1) mesh: bitwise equal to the local plan, the kernels launched, no
    plain version; then a lost rank degrades the plan to the local one,
    with one plan_downgrade."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.fft as tfft
    from repro_torch.core.resilience import clear_events, events, meshstate
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    mesh = init_device_mesh("cuda", dims,
                            mesh_dim_names=("data", "model")[:len(dims)])
    try:
        if kind == "c2c":
            x = _planes(rng, shape, cuda)
        else:
            x = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                  ).to(cuda),)
        km.reset_counts()
        p = tfft.plan(kind=kind, shape=shape, mesh=mesh,
                      placement="distributed", overlap=overlap)
        run = p.execute if kind == "c2c" else p.execute_real
        y = run(*x)
        assert km.matfft_cols.launches > 0
        assert not km.plain_shapes
        local = tfft.plan(kind=kind, shape=shape, device=cuda)
        assert _same(y, (local.execute if kind == "c2c"
                         else local.execute_real)(*x))
        clear_events()
        meshstate.lose_devices([0])
        try:
            d = tfft.plan(kind=kind, shape=shape, mesh=mesh,
                          placement="distributed", overlap=overlap,
                          fallback="degrade")
        finally:
            meshstate.restore_devices()
        assert d is local and len(events("plan_downgrade")) == 1
    finally:
        tfft.invalidate_mesh(mesh)  # its plans hold the group
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["matfft", "stockham"])
@pytest.mark.parametrize("verify", ["off", "abft"])
def test_service_on_the_card(cuda, impl, verify):
    """The service's launches on the card: every request of the default
    mix ok and bitwise equal to the oracle at its launch size, and within
    5e-6 of torch.fft; no plain version ran."""
    from repro_torch.serve import FftService, loadgen
    km.reset_counts()
    service = FftService(impl=impl, device="cuda", coalesce=4,
                         verify=verify)
    records = loadgen.drive(service, num_requests=48, clients=3, seed=5)
    assert [loadgen.classify(r) for r in records] == ["ok"] * 48
    service.close(drain=True)
    assert service.idle() and not km.plain_shapes
    for rec in records:
        ops = loadgen.request_operands(5, rec.rid, rec.shape)
        want = loadgen.oracle(rec.shape, ops, impl=impl,
                              batch_rows=rec.ticket.batch_rows)
        assert loadgen.bitwise_equal(rec.ticket.value, want)
        if rec.shape.kind == "c2c":
            lib = np.fft.fft(ops[0].astype(np.float64) + 1j * ops[1])
        else:
            lib = np.fft.rfft(ops[0].astype(np.float64))
        got = rec.ticket.value[0] + 1j * rec.ticket.value[1].astype(
            np.float64)
        assert np.abs(got - lib).max() / np.abs(lib).max() < TOL


# ---------------------------------------------------------------------------
# the three-pass bodies and K2 at the one tile, over a ragged last block,
# bitwise


def _same(got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _k1_into_nan(x, epilogue=None, global_twiddle=None):
    """K1 launched as `km.matfft` launches it, into output planes filled
    with NaN beforehand: a word the kernel leaves unwritten stays NaN."""
    rows, n = x[0].shape
    yr, yi = (torch.full_like(t, float("nan")) for t in x)
    wr, wi = km.leaf_tables(n, x[0].device)
    er, ei = epilogue if epilogue is not None else (None, None)
    rc = km._lib().matfft_rows(
        x[0].data_ptr(), x[1].data_ptr(), yr.data_ptr(), yi.data_ptr(), rows,
        n, wr.data_ptr(), wi.data_ptr(),
        er.data_ptr() if er is not None else None,
        ei.data_ptr() if ei is not None else None,
        er.shape[0] if er is not None else 1,
        *km._global_twiddle_args(global_twiddle, x[0].device),
        torch.cuda.current_stream(x[0].device).cuda_stream)
    assert rc == 0
    return yr, yi


@pytest.mark.gpu
@pytest.mark.parametrize("n", [512, 1024, 2048, 4096])
@pytest.mark.parametrize("epilogue", ["none", "periodic", "twiddle"])
def test_k1_three_pass_tiles_and_epilogues_equal_the_plain_version(
        cuda, rng, n, epilogue):
    """K1's three-pass body loads its rows from device memory into pass
    1's registers and stores pass 3's registers to device memory: over a
    ragged last block, with no epilogue, the periodic table
    (period 4) and the global twiddle across the 2^32 wrap of its logical
    rows, it writes every output word, with the plain version's bits."""
    rows = 1001
    x = _planes(rng, (rows, n), cuda)
    kw = {"none": {},
          "periodic": {"epilogue": _planes(rng, (4, n), cuda)},
          "twiddle": {"global_twiddle": (1 << 32, (1 << 32) - 600)}}[epilogue]
    want = km.matfft_plain(*x, **kw)
    assert _same(_k1_into_nan(x, **kw), want)


def _k3_into_nan(x, untangle):
    """K3 launched as `km.rfft_leaf` (untangle) or `km.rfft_pack_leaf`
    launches it, into output planes filled with NaN beforehand."""
    rows, n = x.shape
    m = n // 2
    shape = (rows, m + 1 if untangle else m)
    yr, yi = (torch.full(shape, float("nan"), device=x.device)
              for _ in range(2))
    wr, wi = km.leaf_tables(m, x.device)
    vr, vi = km.rfft_twiddle(n, x.device)
    rc = km._lib().matfft_rfft(
        x.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows, m, wr.data_ptr(),
        wi.data_ptr(), vr.data_ptr(), vi.data_ptr(), int(untangle),
        torch.cuda.current_stream(x.device).cuda_stream)
    assert rc == 0
    return yr, yi


def _bits(planes):
    return tuple(t.view(torch.int32) for t in planes)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [512, 1024, 2048, 4096])
@pytest.mark.parametrize("untangle", [True, False])
def test_k3_three_pass_tiles_equal_the_plain_version(cuda, rng, m, untangle):
    """K3's three-pass body loads its packed rows from device memory into
    pass 1's registers; without the untangle it stores pass 3's registers
    to device memory, with it it untangles each pair k, m-k once. Over a
    ragged last block it writes every output word with the plain version's
    bits (signs of zeros too). Planted rows set the pair
    logic's edges: a constant row (X[0] alone), a row at +-1 alternating
    (the Nyquist bin alone) and one of period 4 (X[m/2] alone)."""
    rows, n = 1001, 2 * m
    x = torch.from_numpy(rng.standard_normal((rows, n))
                         .astype(np.float32)).to(cuda)
    j = torch.arange(n, device=cuda)
    x[0] = 1.0
    x[1] = 1.0 - 2.0 * (j % 2)
    x[2] = 1.0 - 2.0 * ((j // 2) % 2)
    plain = km.rfft_leaf_plain if untangle else km.rfft_pack_leaf_plain
    want = plain(x)
    if untangle:
        assert float(want[0][0, 0]) == n and float(want[0][1, m]) == n
        assert float(want[0][2, m // 2]) == m == -float(want[1][2, m // 2])
    got = _k3_into_nan(x, untangle)
    assert _same(_bits(got), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("L,C,off,nc", [(256, 256, 0, None),
                                        (1024, 64, 0, None),
                                        (256, 64, 32, 16),
                                        (4096, 8, 4, 4),
                                        (256, 64, 8, 8),
                                        (2048, 64, 0, None),
                                        (4096, 64, 0, None)])
@pytest.mark.parametrize("out_major", ["row", "col"])
def test_k2_blocks_and_clusters_equal_the_plain_version(cuda, rng, L, C,
                                                       off, nc, out_major):
    """One block alone or a thread-block cluster of 2, 4 or 8
    (`plan.col_cluster`) gives the plain version's bits; the launch key
    records the cluster."""
    x = _planes(rng, (3, L, C), cuda)
    epi = _planes(rng, (C, L), cuda)
    kw = dict(out_major=out_major, epilogue=epi, col_offset=off, ncols=nc)
    want = km.matfft_cols_plain(*x, **kw)
    km.launch_shapes.clear()
    assert _same(km.matfft_cols(*x, **kw), want)
    _, K = tplan.col_cluster(L, nc or C - off)
    [key] = km.launch_shapes
    assert (key[3][-2:] == ("cluster", K)) if K > 1 else (
        len(key) == 3 or "cluster" not in key[3]), key


@pytest.mark.gpu
def test_k2_refuses_a_cluster_it_does_not_take(cuda, rng):
    """The kernel's own checks (plan.check_col_cluster's counterpart):
    a cluster whose blocks do not make 8 columns is refused, and nothing
    runs instead."""
    x = _planes(rng, (1, 4096, 64), cuda)
    y = [torch.full((64, 4096), 7.0, device=cuda) for _ in range(2)]
    wr, wi = km.leaf_tables(4096, cuda)
    # K * R != 8, K not a power of two, K > 8, and a cluster of 8 over
    # planes that start 4 bytes past 16
    for K, skew in ((2, 0), (3, 0), (16, 0), (8, 4)):
        rc = km._lib().matfft_cols(
            x[0].data_ptr() + skew, x[1].data_ptr(), y[0].data_ptr(),
            y[1].data_ptr(), 1, 4096, 64, 0, 64, wr.data_ptr(),
            wi.data_ptr(), None, None, 0, None, None, None, None, 0, 0, K,
            torch.cuda.current_stream(cuda).cuda_stream)
        assert rc != 0, K
    assert bool((y[0] == 7.0).all()) and bool((y[1] == 7.0).all())
    with pytest.raises(ValueError):
        tplan.check_col_cluster(4096, 1, 64, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("out_major", ["row", "col"])
def test_k2_takes_one_block_on_planes_off_16_bytes(cuda, rng, out_major):
    """Planes that do not start on 16 bytes launch one block a tile, no
    cluster, and give the plain version's bits."""
    x = [torch.zeros(2 * 4096 * 64 + 1, device=cuda)[1:].view(2, 4096, 64)
         for _ in range(2)]
    for t, a in zip(x, _planes(rng, (2, 4096, 64), cuda)):
        t.copy_(a)
    km.launch_shapes.clear()
    got = km.matfft_cols(*x, out_major=out_major)
    assert dict(km.launch_shapes) == {
        ("matfft_cols", (2, 4096, 64), out_major): 1}
    assert _same(got, km.matfft_cols_plain(*x, out_major=out_major))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,rows", [("c2c", 1024, 8192),
                                         ("c2c", 1 << 16, 16),
                                         ("r2c", 4096, 256)])
def test_tuned_plan_on_the_card(cuda, rng, tmp_path, kind, n, rows):
    """plan(tune=True) measures on the card (one layout at level 0, where
    both launch the same kernel; both at level 1), equals the default plan
    bit for bit, and a second call is a wisdom hit with no measurement."""
    import repro_torch.fft as tfft
    from repro_torch.fft import tuner
    wp = str(tmp_path / "wisdom.json")
    tuner.reset_tune_stats()
    kw = dict(kind=kind, n=n, batch_shape=(rows,))
    tuned = tfft.plan(**kw, tune=True, wisdom_path=wp)
    stats = tuner.tune_stats()
    assert stats["measurements"] == (2 if n > tplan.MAX_LEAF else 1)
    default = tfft.plan(**kw)
    if kind == "r2c":
        x = (torch.from_numpy(rng.standard_normal((rows, n))
                              .astype(np.float32)).to(cuda),)
        run = "execute_real"
    else:
        x = _planes(rng, (rows, n), cuda)
        run = "execute"
    assert _same(getattr(tuned, run)(*x), getattr(default, run)(*x))
    tfft.clear_plan_cache()
    again = tfft.plan(**kw, tune=True, wisdom_path=wp)
    assert tuner.tune_stats()["measurements"] == stats["measurements"]
    assert tfft.cache_info()["wisdom_hits"] == 1
    assert again.spec == tuned.spec


# ---------------------------------------------------------------------------
# LM training on the card (torch ops, no kernel of csrc/)


def _train_state(model, opt):
    params = model.param_tree()
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-3b", "zamba2-7b",
                                  "whisper-base"])
def test_reduced_train_step_on_the_card_matches_the_host(cuda, arch):
    """One SGD step of a reduced config on the card and on the host from
    the same parameters and batch: the loss and the updated parameters
    within 1e-5 (max|d| / max|host|). The attention configs take wq and
    wk at their true fan-in, as the CPU tests do: at the reference's
    init their gradients move with every rounding."""
    from repro_torch.configs import get_config
    from repro_torch.models.conditioning import FLOAT64, condition
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import TrainerConfig, make_train_step
    from repro_torch.tree import tree_leaves

    cut = ({"dtype": "float64", "cache_dtype": "float64"}
           if arch in FLOAT64 else {})
    cfg = get_config(arch).reduced(**cut)
    model = TransformerLM(cfg, device=cuda)
    condition(model, 1, conditioned=True)
    host = TransformerLM(cfg, device="meta")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                         assign=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (2, 40)))}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
    tc = TrainerConfig(optimizer="sgd", base_lr=1e-2, warmup_steps=0,
                       total_steps=10)
    out = []
    for m, b in ((model, {k: v.to(cuda) for k, v in batch.items()}),
                 (host, batch)):
        opt, step = make_train_step(m, tc)
        state, metrics = step(_train_state(m, opt), b)
        out.append((float(metrics["loss"]), tree_leaves(state["params"])))
    (card_loss, card_p), (host_loss, host_p) = out
    assert abs(card_loss - host_loss) < 1e-5 * host_loss
    for a, b in zip(card_p, host_p):
        a, b = a.detach().cpu(), b.detach()
        assert float((a - b).abs().max()) < 1e-5 * float(b.abs().max())


@pytest.mark.gpu
def test_loss_decreases_over_ten_steps_on_the_card(cuda, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, synthetic_corpus
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config("qwen2-0.5b").reduced()
    model = TransformerLM(cfg, device=cuda)
    model.rescale_qk_to_fan_in()
    store = synthetic_corpus(tmp_path, vocab_size=cfg.vocab_size,
                             n_tokens=50_000, block_tokens=8192)
    tr = Trainer(model, TrainerConfig(base_lr=1e-3, warmup_steps=2,
                                      total_steps=10, log_every=5))
    state, hist = tr.run(tr.init_state(), iter(TokenPipeline(
        store, batch=4, seq=64)), steps=10)
    assert [h["step"] for h in hist] == [5, 10]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert state["params"]["embed"].device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_mesh_trainer_on_one_card_equals_one_device(cuda, tmp_path,
                                                    optimizer):
    """`Trainer(mesh=)` on a world-size-1 NCCL (1, 1) mesh, reduced
    qwen2-0.5b, two steps: the losses, grad norms and every state leaf
    bit for bit the one-device trainer's on the card, and so are the
    models' parameters after `run`; the mesh's checkpoint restores into
    the one-device trainer bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves
    cfg = get_config("qwen2-0.5b").reduced()
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 64))
                .astype(np.int32)} for _ in range(2)]
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        runs = []
        for m in (None, mesh):
            tc = TrainerConfig(optimizer=optimizer, base_lr=1e-3,
                               warmup_steps=0, total_steps=10, log_every=1,
                               ckpt_dir=str(tmp_path / f"ck_{m is None}"))
            model = TransformerLM(cfg, device=cuda,
                                  generator=torch.Generator(cuda)
                                  .manual_seed(0))
            tr = Trainer(model, tc, mesh=m)
            state, hist = tr.run(tr.init_state(), iter(batches), 2)
            leaves = [x.full_tensor() if m is not None else x.detach()
                      for x in tree_leaves(state)]
            assert all(x.device.type == "cuda" for x in leaves)
            runs.append((hist, leaves, tree_leaves(model.param_tree())))
        (h1, s1, m1), (h2, s2, m2) = runs
        assert [[h[k] for k in ("loss", "grad_norm")] for h in h1] == [
            [h[k] for k in ("loss", "grad_norm")] for h in h2]
        assert len(s1) == len(s2)
        assert all(torch.equal(a, b) for a, b in zip(s1, s2))
        # the models hold the trained weights after run
        assert all(torch.equal(a, b) for a, b in zip(m1, m2))
        # the mesh's checkpoint into the one-device trainer
        tc = TrainerConfig(optimizer=optimizer,
                           ckpt_dir=str(tmp_path / "ck_False"))
        tr = Trainer(TransformerLM(cfg, device=cuda), tc)
        restored = tr.restore_or_init()
        assert int(restored["step"]) == 2
        assert all(torch.equal(a.detach(), b)
                   for a, b in zip(tree_leaves(restored), s2))
    finally:
        dist.destroy_process_group()
