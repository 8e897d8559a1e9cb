"""The port's segmented and 1-D distributed placements on torch.distributed,
against the JAX package's on 8 forced host devices.

Both sides run once per test session, in subprocesses of this file,
started together: the reference (``python test_torch_distributed.py
reference``, with XLA_FLAGS=--xla_force_host_platform_device_count=8 set
before JAX is imported) and 8 workers of the port (``... worker <rank>``)
joined in one ``gloo`` group through a FileStore in the session's tmp
directory, on a (4, 2) ("data", "model") mesh. Under xdist the first
worker to take a lock runs them and the others read its results. Inputs
come from a numpy seed and travel as .npz files, and so do the outputs;
the workers import no JAX. The tests then read what both wrote. Every
process group has a 60 s timeout and the subprocesses a bound, so a stuck
collective fails the module, never the whole run.
"""

import datetime
import fcntl
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TOL = 5e-6  # max|port - ref| / max|ref| (fft/selftest.py)
TOL_ROUND = 1e-4  # inverse(forward(x)) against x (test_distributed_fft.py)
N_OPT = 4096  # n1 = n2 = 64: 8 columns a rank, chunks 1, 4 and 8
# the cost model's configurations: (natural_order, fuse_twiddle, overlap)
COST_CASES = [(nat, fuse, ov) for nat in (True, False)
              for fuse in (False, True) for ov in ("off", 4)]
COST_FIELDS = ("hbm_bytes", "collective_bytes", "exposed_collective_bytes",
               "flops", "gemm_macs")


def _inputs(path: Path) -> None:
    rng = np.random.default_rng(0)

    def planes(*shape):
        return rng.standard_normal((2, *shape)).astype(np.float32)

    np.savez(path, d64=planes(64), d4096=planes(4096), d65536=planes(65536),
             x=planes(N_OPT), seg=planes(16, 512),
             seg_real=rng.standard_normal((16, 512)).astype(np.float32),
             selftest=planes(4096))


# ---------------------------------------------------------------------------
# the reference: the JAX package on 8 forced host devices


def _reference(inputs: str, out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import repro.fft as fft_api
    from repro import compat
    from repro.core.fft.distributed import distributed_fft

    x = dict(np.load(inputs))
    mesh = compat.make_mesh((4, 2), ("data", "model"))
    res = {}

    def keep(name, y):
        res[name] = np.stack([np.asarray(a) for a in y])

    def dist_run(name, planes, **kw):
        keep(name, distributed_fft(jnp.asarray(planes[0]),
                                   jnp.asarray(planes[1]), mesh, **kw))

    for n in (64, 4096, 65536):
        dist_run(f"dist_{n}", x[f"d{n}"])
    dist_run("transposed", x["x"], natural_order=False)
    dist_run("fused", x["x"], fuse_twiddle=True)
    dist_run("reversed_axes", x["x"], axis_names=("model", "data"))
    for name, kind, impl in (("seg_c2c", "c2c", "matfft"),
                             ("seg_r2c", "r2c", "matfft"),
                             ("seg_stockham", "c2c", "stockham")):
        p = fft_api.plan(kind=kind, n=512, batch_shape=(16,), mesh=mesh,
                         placement="segmented", impl=impl)
        keep(name, p.execute_real(jnp.asarray(x["seg_real"]))
             if kind == "r2c" else p.execute(*map(jnp.asarray, x["seg"])))
    res["cost"] = np.array([
        [getattr(fft_api.plan(kind="c2c", n=N_OPT, mesh=mesh,
                              placement="distributed", natural_order=nat,
                              fuse_twiddle=fuse, overlap=ov), f)
         for f in COST_FIELDS] for nat, fuse, ov in COST_CASES])
    mesh8 = compat.make_mesh((8,), ("data",))
    p = fft_api.plan(kind="c2c", n=4096, mesh=mesh8, placement="distributed",
                     overlap="off", interpret=True)
    keep("selftest", p.execute(*map(jnp.asarray, x["selftest"])))
    # which shard each mesh position holds: (data, model, shard index)
    coords = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
    for axes in (("data", "model"), ("model", "data")):
        arr = jax.device_put(jnp.arange(WORLD), NamedSharding(mesh, P(axes)))
        res["order_" + "_".join(axes)] = np.array(sorted(
            (*coords[s.device.id], s.index[0].start or 0)
            for s in arr.addressable_shards))
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the port: one gloo rank of 8


def _worker(rank: int, store: str, inputs: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.fft as tfft
    from repro_torch.core.fft.distributed import (flat_ranks, mesh_axes,
                                                  plan_distributed)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        x = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        res, info = {}, {}

        def gather(y, m=mesh, axes=None):
            """The global planes from every rank's output shard."""
            order = flat_ranks(m, mesh_axes(m, axes))
            parts = []
            for t in y:
                got = [torch.empty_like(t) for _ in range(WORLD)]
                dist.all_gather(got, t.contiguous())
                parts.append(torch.cat([got[r] for r in order]).numpy())
            return np.stack(parts)

        # count the collectives the engines call
        calls = Counter()
        real_a2a, real_p2p = dist.all_to_all_single, dist.batch_isend_irecv

        def counted_a2a(*a, **kw):
            calls["all_to_all_single"] += 1
            return real_a2a(*a, **kw)

        def counted_p2p(ops):
            calls["batch_isend_irecv"] += 1
            sends = [op for op in ops if op.op.__name__ == "isend"]
            calls["sends"] += len(sends)
            calls["rounds"] += len({op.peer for op in sends})
            return real_p2p(ops)

        dist.all_to_all_single = counted_a2a
        dist.batch_isend_irecv = counted_p2p

        def run(planes, m=mesh, axes=None, **kw):
            """Plan on ``m``, execute this rank's shard; (plan, output
            shard, the collectives of the call)."""
            p = tfft.plan(kind="c2c", n=planes.shape[-1], mesh=m,
                          placement="distributed", axes=axes, **kw)
            shard = [tfft.local_shard(a, m, axes) for a in planes]
            calls.clear()
            y = p.execute(*shard)
            return p, y, dict(calls), shard

        for n in (64, 4096, 65536):
            p, y, c, shard = run(x[f"d{n}"])
            res[f"dist_{n}"] = gather(y)
            info[f"calls_{n}"] = c
            back = p.execute_inverse(*y)
            res[f"roundtrip_{n}"] = gather(back)
        p, y, c, _ = run(x["x"], natural_order=False)
        res["transposed"] = gather(y)
        info["calls_transposed"] = c
        res["unfused"] = gather(run(x["x"])[1])
        res["fused"] = gather(run(x["x"], fuse_twiddle=True)[1])
        res["reversed_axes"] = gather(
            run(x["x"], axes=("model", "data"))[1], axes=("model", "data"))

        # overlap == off bitwise: the reference's cases, and the copy layout
        parity = {}
        cases = ([(True, False, k, "zero_copy") for k in (1, 4, 8)]
                 + [(True, True, k, "zero_copy") for k in (4, 8)]
                 + [(False, False, 4, "zero_copy"), (False, True, 4,
                                                     "zero_copy")]
                 + [(True, False, 4, "copy"), (True, True, 8, "copy")])
        for natural, fuse, k, layout in cases:
            kw = dict(natural_order=natural, fuse_twiddle=fuse, layout=layout)
            off = gather(run(x["x"], overlap="off", **kw)[1])
            on = gather(run(x["x"], overlap=k, **kw)[1])
            parity[f"nat={natural},fuse={fuse},chunks={k},{layout}"] = bool(
                (off == on).all())
        info["overlap_parity"] = parity

        # the overlapped engine: its exchanges, its cache entry, its
        # exposed bytes and its inverse
        p_on, y, c, shard = run(x["x"], overlap=4)
        info["calls_overlap"] = c
        before = tfft.cache_info()
        same = tfft.plan(kind="c2c", n=N_OPT, mesh=mesh,
                         placement="distributed", overlap=4)
        p_on.execute(*shard)
        info["overlap_cache"] = {
            "same_plan": same is p_on,
            "hits": tfft.cache_info()["hits"] - before["hits"],
            "builds": p_on.build_counts["forward"],
            "exposed": p_on.exposed_collective_bytes,
            "total": p_on.collective_bytes,
            "dist": [p_on.dist.n1, p_on.dist.n2, p_on.dist.chunks]}
        res["overlap_roundtrip"] = gather(p_on.execute_inverse(*y))
        res["overlap_input"] = gather(shard)
        try:
            p_tr = tfft.plan(kind="c2c", n=N_OPT, mesh=mesh,
                             placement="distributed", natural_order=False)
            p_tr.execute_inverse(*shard)
            info["transposed_inverse_raises"] = False
        except NotImplementedError:
            info["transposed_inverse_raises"] = True
        dropped = tfft.invalidate_mesh(mesh)
        info["invalidated"] = [dropped, tfft.plan(
            kind="c2c", n=N_OPT, mesh=mesh, placement="distributed",
            overlap=4) is not p_on]

        info["cost"] = [
            [getattr(tfft.plan(kind="c2c", n=N_OPT, mesh=mesh,
                               placement="distributed", natural_order=nat,
                               fuse_twiddle=fuse, overlap=ov), f)
             for f in COST_FIELDS] for nat, fuse, ov in COST_CASES]

        # n < D^2 raises at plan time
        for what, fn in (
                ("plan_distributed", lambda: plan_distributed(32, WORLD)),
                ("plan", lambda: tfft.plan(kind="c2c", n=32, mesh=mesh,
                                           placement="distributed"))):
            try:
                fn()
                info[f"too_small_{what}"] = False
            except ValueError:
                info[f"too_small_{what}"] = True

        # segmented: every collective raises while its plans build and run
        names = ("all_to_all_single", "all_to_all", "batch_isend_irecv",
                 "all_gather", "all_gather_into_tensor", "all_reduce",
                 "broadcast", "reduce_scatter_tensor", "send", "recv",
                 "isend", "irecv", "barrier", "gather", "scatter")
        saved = {name: getattr(dist, name) for name in names}

        def collective(*a, **kw):
            raise AssertionError("a collective in the segmented placement")

        seg = {}
        for name in names:
            setattr(dist, name, collective)
        try:
            for case, kind, impl in (("seg_c2c", "c2c", "matfft"),
                                     ("seg_r2c", "r2c", "matfft"),
                                     ("seg_stockham", "c2c", "stockham")):
                p = tfft.plan(kind=kind, n=512, batch_shape=(16,), mesh=mesh,
                              impl=impl)
                if kind == "r2c":
                    y = p.execute_real(tfft.local_shard(x["seg_real"], mesh))
                else:
                    y = p.execute(*(tfft.local_shard(a, mesh)
                                    for a in x["seg"]))
                local = tfft.plan(kind=kind, n=512, batch_shape=(2,),
                                  impl=impl, device="cpu")
                want = (local.execute_real(tfft.local_shard(x["seg_real"],
                                                            mesh))
                        if kind == "r2c" else local.execute(
                            *(tfft.local_shard(a, mesh) for a in x["seg"])))
                seg[case] = (y, p.placement, all(torch.equal(a, b)
                                                 for a, b in zip(y, want)))
            info["seg_no_collective"] = True
        except AssertionError:
            info["seg_no_collective"] = False
        finally:
            for name, fn in saved.items():
                setattr(dist, name, fn)
        for case, (y, placement, same_as_local) in seg.items():
            res[case] = gather(y)
            info[case] = [placement, same_as_local]

        # the selftest's two distributed cases on an 8-rank ("data",) mesh
        mesh8 = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
        for name, overlap in (("selftest_off", "off"),
                              ("selftest_overlap4", 4)):
            p, y, c, _ = run(x["selftest"], m=mesh8, overlap=overlap)
            p.execute(*(tfft.local_shard(a, mesh8) for a in x["selftest"]))
            res[name] = gather(y, m=mesh8)
            info[name] = {"builds": p.build_counts["forward"],
                          "exposed": p.exposed_collective_bytes,
                          "total": p.collective_bytes}

        # rank order: this rank's coordinate and the shard it holds
        order = {}
        for axes in (("data", "model"), ("model", "data")):
            shard = tfft.local_shard(torch.arange(WORLD), mesh, axes)
            order["_".join(axes)] = [*mesh.get_coordinate(),
                                     int(shard[0])]
        ranks = [None] * WORLD
        dist.all_gather_object(ranks, order)
        info["order"] = {k: sorted(r[k] for r in ranks) for k in order}
        if rank == 0:
            np.savez(Path(out) / "port.npz", **res)
            (Path(out) / "port.json").write_text(json.dumps(info))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the module's one run of both sides


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # once per session: under xdist the workers share the session's base
    # directory, and the first to take the lock runs both sides for all
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    tmp = base / "torch_distributed"
    with open(base / "torch_distributed.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (tmp / "done").exists():
                tmp.mkdir(exist_ok=True)
                try:
                    _run_both_sides(tmp)
                    (tmp / "done").write_text("ok")
                except BaseException as e:
                    (tmp / "done").write_text(f"failed: {e}")
                    raise
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    done = (tmp / "done").read_text()
    assert done == "ok", done
    return (dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "port.npz")),
            json.loads((tmp / "port.json").read_text()),
            dict(np.load(tmp / "inputs.npz")))


def _run_both_sides(tmp: Path) -> None:
    _inputs(tmp / "inputs.npz")
    base = {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    me = [sys.executable, str(Path(__file__).resolve())]
    jobs = [("reference", [str(tmp / "inputs.npz"), str(tmp / "ref.npz")],
             {**base, "JAX_PLATFORMS": "cpu",
              "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})]
    jobs += [(f"worker {r}", [str(r), str(tmp / "store"),
                              str(tmp / "inputs.npz"), str(tmp)], base)
             for r in range(WORLD)]
    procs = []
    for name, args, env in jobs:
        log = tmp / f"{name.replace(' ', '_')}.log"
        with open(log, "w") as f:
            procs.append((name, log, subprocess.Popen(
                [*me, name.split()[0], *args], env=env, stdout=f,
                stderr=subprocess.STDOUT)))
    deadline = time.monotonic() + 240
    failed = []
    try:
        for name, log, proc in procs:
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timed out"
            if rc:
                failed.append(f"{name}: {rc}\n{log.read_text()[-3000:]}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not failed, "\n".join(failed)


def _rel_err(got, want) -> float:
    g = got[0].astype(np.float64) + 1j * got[1]
    w = want[0].astype(np.float64) + 1j * want[1]
    return float(np.abs(g - w).max() / np.abs(w).max())


def _numpy_fft(planes, axis=-1):
    return np.fft.fft(planes[0].astype(np.float64) + 1j * planes[1],
                      axis=axis)


def _split(y):
    return np.stack([y.real, y.imag])


@pytest.mark.parametrize("n", [64, 4096, 65536])
def test_distributed_matches_numpy_and_the_reference(runs, n):
    ref, port, _, x = runs
    assert _rel_err(port[f"dist_{n}"], ref[f"dist_{n}"]) < TOL
    assert _rel_err(port[f"dist_{n}"], _split(_numpy_fft(x[f"d{n}"]))) < TOL


@pytest.mark.parametrize("n", [64, 4096, 65536])
def test_distributed_roundtrip(runs, n):
    _, port, _, x = runs
    assert np.abs(port[f"roundtrip_{n}"] - x[f"d{n}"]).max() < TOL_ROUND


def test_plan_rejects_too_small(runs):
    from repro.core.fft.distributed import plan_distributed as jplan_dist
    from repro_torch.core.fft.distributed import plan_distributed
    _, _, info, _ = runs
    assert info["too_small_plan_distributed"] and info["too_small_plan"]
    for fn in (plan_distributed, jplan_dist):
        with pytest.raises(ValueError, match="n >= D"):
            fn(32, 8)


def test_segmented_correct_and_collective_free(runs):
    """The paper's map-only property: no collective is called, and each
    rank's rows equal the local plan's on the same rows, bitwise."""
    ref, port, info, x = runs
    assert info["seg_no_collective"]
    assert info["seg_c2c"] == ["segmented", True]
    assert _rel_err(port["seg_c2c"], ref["seg_c2c"]) < TOL
    assert _rel_err(port["seg_c2c"], _split(_numpy_fft(x["seg"]))) < TOL


@pytest.mark.parametrize("case", ["seg_r2c", "seg_stockham"])
def test_segmented_r2c_and_stockham(runs, case):
    ref, port, info, x = runs
    assert info[case] == ["segmented", True]
    assert _rel_err(port[case], ref[case]) < TOL
    if case == "seg_r2c":
        want = np.fft.rfft(x["seg_real"].astype(np.float64), axis=-1)
    else:
        want = _numpy_fft(x["seg"])
    assert _rel_err(port[case], _split(want)) < TOL


def test_distributed_uses_all_to_all_single(runs):
    """The monolithic engine: one all_to_all_single a plane and exchange
    (three exchanges, two with TRANSPOSED_OUT), no point-to-point."""
    _, _, info, _ = runs
    for n in (64, 4096, 65536):
        assert info[f"calls_{n}"] == {"all_to_all_single": 6}
    assert info["calls_transposed"] == {"all_to_all_single": 4}


def test_overlap_bitwise_parity(runs):
    """The slabs' rounds move data around the same kernels: every overlap
    configuration equals the monolithic engine bit for bit."""
    _, _, info, _ = runs
    assert info["overlap_parity"] and all(info["overlap_parity"].values()), \
        info["overlap_parity"]


def test_overlap_plan_cache_and_exposed_bytes(runs):
    from repro.core.fft.distributed import plan_distributed as jplan_dist
    _, _, info, _ = runs
    c = info["overlap_cache"]
    assert c["same_plan"] and c["hits"] == 1 and c["builds"] == 1
    # chunks=4 exposes a quarter of the collective payload, as in the
    # reference's cost model
    assert c["exposed"] * 4 == c["total"]
    want = jplan_dist(N_OPT, WORLD, chunks=4)
    assert c["total"] == WORLD * want.collective_bytes_per_device
    assert c["dist"] == [want.n1, want.n2, 4]
    assert info["invalidated"][0] >= 1 and info["invalidated"][1]


def test_overlap_exchanges_are_batched_rounds(runs):
    """3 exchanges x 4 slabs, each one batch_isend_irecv list of D - 1
    rounds (one send a plane and round), and no all_to_all_single."""
    _, _, info, _ = runs
    assert info["calls_overlap"] == {"batch_isend_irecv": 3 * 4,
                                     "sends": 3 * 4 * (WORLD - 1) * 2,
                                     "rounds": 3 * 4 * (WORLD - 1)}


def test_overlap_inverse_roundtrip(runs):
    _, port, info, _ = runs
    err = np.abs(port["overlap_roundtrip"] - port["overlap_input"]).max()
    assert err < TOL_ROUND
    assert info["transposed_inverse_raises"]


def test_fuse_twiddle_matches_unfused_and_the_reference(runs):
    ref, port, _, x = runs
    assert _rel_err(port["fused"], port["unfused"]) < TOL
    assert _rel_err(port["fused"], ref["fused"]) < TOL
    assert _rel_err(port["fused"], _split(_numpy_fft(x["x"]))) < TOL


def test_transposed_out_matches_the_reference(runs):
    """natural_order=False: rank f holds rows o1 of the (n1, n2)
    TRANSPOSED_OUT layout, as the reference's out_specs lay them."""
    ref, port, info, x = runs
    assert _rel_err(port["transposed"], ref["transposed"]) < TOL
    n1, n2, _ = info["overlap_cache"]["dist"]
    want = _numpy_fft(x["x"]).reshape(n2, n1).T.reshape(-1)
    assert _rel_err(port["transposed"], _split(want)) < TOL


@pytest.mark.parametrize("case", ["selftest_off", "selftest_overlap4"])
def test_selftest_distributed_cases(runs, case):
    """fft/selftest.py's c2c/dist_off and c2c/dist_overlap4 on an 8-rank
    ("data",) mesh: within 5e-6 of numpy, one build for two executes,
    overlap == off bitwise."""
    ref, port, info, x = runs
    assert _rel_err(port[case], _split(_numpy_fft(x["selftest"]))) < TOL
    assert _rel_err(port[case], ref["selftest"]) < TOL
    assert info[case]["builds"] == 1
    assert (port["selftest_overlap4"] == port["selftest_off"]).all()
    assert info["selftest_overlap4"]["exposed"] * 4 == \
        info["selftest_overlap4"]["total"]


@pytest.mark.parametrize("axes", ["data_model", "model_data"])
def test_rank_order_matches_the_reference(runs, axes):
    """The shard a mesh position holds: the row-major coordinate over the
    axes in the order given, as lax.axis_index(axes) in the reference. On
    (4, 2) a wrong order swaps shards that D = 2 would not notice."""
    ref, _, info, _ = runs
    assert info["order"][axes] == ref["order_" + axes].tolist()


def test_reversed_axes_match_the_reference(runs):
    ref, port, _, x = runs
    assert _rel_err(port["reversed_axes"], ref["reversed_axes"]) < TOL
    assert _rel_err(port["reversed_axes"], _split(_numpy_fft(x["x"]))) < TOL


def test_cost_model_matches_the_reference(runs):
    """hbm_bytes, collective_bytes, exposed_collective_bytes, flops and
    gemm_macs of distributed plans on the (4, 2) mesh, every natural_order
    x fuse_twiddle x overlap, equal the reference plans'."""
    ref, _, info, _ = runs
    assert info["cost"] == ref["cost"].tolist()


@pytest.mark.parametrize("n,d,natural,chunks", [
    (4096, 8, True, None), (4096, 8, False, 4), (1 << 20, 4, True, 2),
    (1 << 24, 1, True, 4), (64, 8, True, None)])
def test_dist_plan_bytes_match_the_reference(n, d, natural, chunks):
    from repro.core.fft.distributed import plan_distributed as jplan_dist
    from repro_torch.core.fft.distributed import plan_distributed
    got = plan_distributed(n, d, natural_order=natural, chunks=chunks)
    want = jplan_dist(n, d, natural_order=natural, chunks=chunks)
    for name in ("n1", "n2", "n_exchanges", "collective_bytes_per_device",
                 "exposed_collective_bytes_per_device",
                 "per_leg_bytes_per_device",
                 "per_leg_exposed_bytes_per_device"):
        assert getattr(got, name) == getattr(want, name), name


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(*sys.argv[2:])
    else:
        _worker(int(sys.argv[2]), *sys.argv[3:])
