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
import math
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
# the pencils: tests/test_pencil_nd.py's 3-D volume on the (4, 2) mesh, and
# tests/test_fft2_plan.py's images on the 8-rank ("data",) mesh; a leading
# axis past the port's 4096 leaf (axis_pass's transpose fallback)
SHAPE3 = (16, 32, 64)
SHAPE2 = (64, 64)
SHAPE2_R2C = (64, 256)
SHAPE2_LONG = (8192, 32)
PENCIL_COST = ("hbm_bytes", "collective_bytes", "exposed_collective_bytes",
               "per_leg_collective_bytes", "per_leg_exposed_collective_bytes",
               "flops", "gemm_macs")
# (kind, shape, mesh, overlap) of each pencil cost case
PENCIL_COST_CASES = [(kind, shape, m, ov) for kind in ("c2c", "r2c")
                     for shape, m in ((SHAPE3, "mesh"), (SHAPE2, "mesh8"),
                                      (SHAPE2_R2C, "mesh8"))
                     for ov in ("off", 2)]
# (result, kind, input, shape, mesh) of each pencil run on both sides
# the service over the mesh: requests of (rows, n), submitted before
# start() so the batcher's grouping is fixed (two launches of 4), under
# each (mesh, verify) case; bench_serve's storm at a small size
SVC_REQUESTS = 8
SVC_SHAPE = (16, 256)
SVC_CASES = [("mesh", "off"), ("mesh", "abft"), ("mesh8", "off")]
SVC_STORM_REQUESTS = 96
PENCIL_RUNS = [("pen3", "c2c", "pen3", SHAPE3, "mesh"),
               ("pen3_r2c", "r2c", "pen3_real", SHAPE3, "mesh"),
               ("pen2", "c2c", "pen2", SHAPE2, "mesh8"),
               ("pen2_r2c", "r2c", "pen2_r2c", SHAPE2_R2C, "mesh8"),
               ("pen2_slice", "r2c", "pen2_real", SHAPE2, "mesh8")]


def _inputs(path: Path) -> None:
    rng = np.random.default_rng(0)

    def planes(*shape):
        return rng.standard_normal((2, *shape)).astype(np.float32)

    np.savez(path, d64=planes(64), d4096=planes(4096), d65536=planes(65536),
             x=planes(N_OPT), seg=planes(16, 512),
             seg_real=rng.standard_normal((16, 512)).astype(np.float32),
             selftest=planes(4096), pen3=planes(*SHAPE3),
             pen3_real=rng.standard_normal(SHAPE3).astype(np.float32),
             pen2=planes(*SHAPE2),
             pen2_real=rng.standard_normal(SHAPE2).astype(np.float32),
             pen2_r2c=rng.standard_normal(SHAPE2_R2C).astype(np.float32),
             pen2_long=planes(*SHAPE2_LONG), loss=planes(4096),
             dead=planes(32, 256),
             svc=rng.standard_normal((SVC_REQUESTS, 2, *SVC_SHAPE))
             .astype(np.float32))


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

    # the pencils (tests/test_pencil_nd.py, tests/test_fft2_plan.py). The
    # reference's r2c pencil plans, but raises ShardingTypeError on this
    # JAX when it runs (its N-D untangle rolls a sharded dim of the global
    # result); its own gate holds it bitwise to the local rfftn plan, so
    # the r2c runs take that plan's output
    meshes = {"mesh": mesh, "mesh8": mesh8}
    for name, kind, key, shape, m in PENCIL_RUNS:
        where = (dict(placement="local") if kind == "r2c" else dict(
            mesh=meshes[m], placement="distributed", overlap="off"))
        p = fft_api.plan(kind=kind, shape=shape, **where)
        keep(name, p.execute_real(jnp.asarray(x[key])) if kind == "r2c"
             else p.execute(*map(jnp.asarray, x[key])))
    res["pencil_cost"] = np.array(json.dumps([
        [np.ravel(getattr(fft_api.plan(
            kind=kind, shape=shape, mesh=meshes[m], placement="distributed",
            overlap=ov), f)).tolist() for f in PENCIL_COST]
        for kind, shape, m, ov in PENCIL_COST_CASES]))

    # tests/test_chaos.py's partial loss: ranks 6 and 7 of an 8-rank mesh
    from repro.core.resilience import (FaultInjector, FaultPlan,
                                       clear_events, events, meshstate)
    mesh_x = compat.make_mesh((8,), ("x",))
    fft_api.plan(kind="c2c", n=4096, mesh=mesh_x, placement="distributed")
    inj = FaultInjector(FaultPlan.random(0, 0, rate=0.0, device_loss=(6, 7)))
    clear_events()
    inj.apply_device_loss(mesh_x)
    p = fft_api.plan(kind="c2c", n=4096, mesh=mesh_x,
                     placement="distributed", fallback="degrade")
    keep("loss", p.execute(*map(jnp.asarray, x["loss"])))
    res["loss_info"] = np.array(json.dumps([
        p.placement, int(p.mesh.devices.size),
        [e["reason"] for e in events("plan_downgrade")]]))
    meshstate.restore_devices()

    # the service over the mesh: each launch's (rows, placement)
    from repro.serve import FftService
    for name, verify in SVC_CASES:
        service = FftService(impl="matfft", mesh=meshes[name], coalesce=4,
                             verify=verify, start=False)
        launches = []
        real = service._plan

        def recorded(key, total, real=real, launches=launches):
            p = real(key, total)
            launches.append([total, p.placement])
            return p

        service._plan = recorded
        tickets = [service.submit("c2c", *q) for q in x["svc"]]
        service.start()
        outs = [t.result(timeout=300) for t in tickets]
        service.close(drain=True)
        case = f"svc_{name}_{verify}"
        res[case] = np.stack([np.stack([np.asarray(a) for a in o])
                              for o in outs])
        res[case + "_launches"] = np.array(json.dumps(launches))
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

        # the pencils: each run under both engines, its output assembled
        # from every rank's block by the coordinate (worked out here, not
        # by the port's layout helpers), held to the local plan
        meshes = {"mesh": mesh, "mesh8": mesh8}

        def block(m, shape, out):
            """This rank's slices of a global volume: input axis 0 (output
            axis 1) over the flat index of every dim for 2-D; axis i (i + 1)
            over mesh dim i for 3-D."""
            coord = m.get_coordinate()
            sizes = [m.size(i) for i in range(m.ndim)]
            if len(shape) == 2:
                f = 0
                for c, size in zip(coord, sizes):
                    f = f * size + c
                grid = [(f, math.prod(sizes))]
            else:
                grid = list(zip(coord, sizes))
            sl = [slice(None)] * len(shape)
            for k, (f, g) in enumerate(grid):
                w = shape[k + out] // g
                sl[k + out] = slice(f * w, (f + 1) * w)
            return tuple(sl)

        def assemble(y, m, shape):
            got = [None] * WORLD
            dist.all_gather_object(got, (block(m, shape, 1),
                                         [t.numpy() for t in y]))
            full = np.zeros((2, *shape), np.float32)
            for sl, planes in got:
                for k in range(2):
                    full[k][sl] = planes[k]
            return full

        pencil = {}
        for name, kind, key, shape, m in (
                *PENCIL_RUNS, ("pen2_long", "c2c", "pen2_long", SHAPE2_LONG,
                               "mesh8")):
            mm, xin = meshes[m], x[key]
            sl = block(mm, shape, 0)
            local = tfft.plan(kind=kind, shape=shape, device="cpu")
            want = np.stack([t.numpy() for t in (
                local.execute(*xin) if kind == "c2c"
                else local.execute_real(xin))])
            outs, case = {}, {}
            for ov in ("off", 2):
                p = tfft.plan(kind=kind, shape=shape, mesh=mm,
                              placement="distributed", overlap=ov)
                calls.clear()
                if kind == "c2c":
                    y = p.execute(xin[0][sl], xin[1][sl])
                    case[f"calls_{ov}"] = dict(calls)
                    outs[ov] = assemble(y, mm, shape)
                    if ov == "off":
                        back = p.execute_inverse(*y)
                        case["roundtrip"] = max(float(
                            (b - a[sl]).abs().max() / a.abs().max())
                            for a, b in zip(xin, back))
                        p.execute(xin[0][sl], xin[1][sl])
                        case["builds"] = p.build_counts["forward"]
                else:
                    y = p.execute_real(xin[sl])  # global, on every rank
                    case[f"calls_{ov}"] = dict(calls)
                    outs[ov] = np.stack([t.numpy() for t in y])
                case[f"fast_{ov}"] = p._fast_r2c_pencil
            res[name] = outs["off"]
            case.update(
                local_bitwise=all(np.array_equal(o, want)
                                  for o in outs.values()),
                engines_bitwise=bool(np.array_equal(outs["off"], outs[2])),
                grid=list(p.dist.grid), d=p.dist.d,
                n_exchanges=p.dist.n_exchanges)
            pencil[name] = case
        info["pencil"] = pencil
        info["pencil_cost"] = [
            [np.ravel(getattr(tfft.plan(
                kind=kind, shape=shape, mesh=meshes[m],
                placement="distributed", overlap=ov), f)).tolist()
             for f in PENCIL_COST]
            for kind, shape, m, ov in PENCIL_COST_CASES]
        # tests/test_fft2_plan.py's one exchange leg, on 512 x 512
        legs = {}
        for ov in ("off", 2):
            p = tfft.plan(kind="c2c", shape=(512, 512), mesh=mesh8,
                          placement="distributed", overlap=ov)
            legs[str(ov)] = [p.dist.n_exchanges, p.collective_bytes,
                             p.exposed_collective_bytes]
        legs["1-D"] = tfft.plan(kind="c2c", n=512 * 512, mesh=mesh8,
                                placement="distributed",
                                overlap="off").collective_bytes
        info["one_leg"] = legs
        # tests/test_pencil_nd.py's spec errors that need the mesh
        errors = {}
        for what, kw in (("axis_count", dict(shape=SHAPE3, axes=("data",))),
                         ("indivisible", dict(shape=(8, 2, 64)))):
            try:
                tfft.plan(kind="c2c", mesh=mesh, placement="distributed",
                          **kw)
                errors[what] = None
            except ValueError as e:
                errors[what] = str(e)
        info["pencil_errors"] = errors

        # the tuner on 8 ranks: a measurer under which each rank has
        # another fastest overlap; one decision for the mesh, written once
        from repro_torch.fft import tuner
        writes = []
        real_record = tuner.WisdomStore.record

        def counted_record(store, key, entry):
            writes.append(key)
            return real_record(store, key, entry)

        def skewed(plan, cfg):
            s = plan.spec
            i = ["off", 2, 4, 8].index(s.overlap)
            return (1.0 + 0.1 * ((i - rank) % 4)
                    + (0.05 if s.layout == "copy" else 0.0)
                    + 0.01 * (rank % 3))

        tuner.WisdomStore.record = counted_record
        tuned = {}
        try:
            cfg = tuner.TuneConfig(measurer=skewed)
            wp = str(Path(out) / "tune_wisdom.json")
            for name, kw, xin in (("dist", dict(n=N_OPT), x["x"]),
                                  ("pencil3", dict(shape=SHAPE3),
                                   x["pen3"])):
                if name == "dist":
                    shard = [tfft.local_shard(a, mesh) for a in xin]
                else:
                    sl = block(mesh, SHAPE3, 0)
                    shard = [a[sl] for a in xin]
                plan_kw = dict(kind="c2c", mesh=mesh,
                               placement="distributed", **kw)
                tuner.reset_tune_stats()
                p = tfft.plan(**plan_kw, tune=True, wisdom_path=wp,
                              tune_config=cfg)
                first = tuner.tune_stats()
                y = p.execute(*shard)
                y0 = tfft.plan(**plan_kw).execute(*shard)
                tfft.clear_plan_cache()
                again = tfft.plan(**plan_kw, tune=True, wisdom_path=wp,
                                  tune_config=cfg)
                second = tuner.tune_stats()
                tuned[name] = {
                    "knobs": [p.spec.layout, p.spec.overlap],
                    "own": ["off", 2, 4, 8][rank % 4],
                    "bitwise_default": all(torch.equal(a, b)
                                           for a, b in zip(y, y0)),
                    "measurements": first["measurements"],
                    "second_measurements": (second["measurements"]
                                            - first["measurements"]),
                    "wisdom_hits": second["wisdom_hits"],
                    "same_again": again.spec == p.spec}
        finally:
            tuner.WisdomStore.record = real_record
        every = [None] * WORLD
        dist.all_gather_object(every, {**tuned, "writes": len(writes)})
        info["tune"] = every

        # benchmarks/bench_tune.py's 3-D pencil gate: both engines bitwise
        # equal to the local fftn, two legs, the per-leg bytes summing up
        want = [np.stack([t.numpy() for t in tfft.plan(
            kind="c2c", shape=SHAPE3, device="cpu").execute(*x["pen3"])])]
        sl = block(mesh, SHAPE3, 0)
        gate = {}
        for ov in ("off", 2):
            p = tfft.plan(kind="c2c", shape=SHAPE3, mesh=mesh,
                          placement="distributed", overlap=ov)
            got = assemble(p.execute(x["pen3"][0][sl], x["pen3"][1][sl]),
                           mesh, SHAPE3)
            gate[f"bitwise_overlap_{ov}"] = all(np.array_equal(got, w)
                                                for w in want)
        p3 = tfft.plan(kind="c2c", shape=SHAPE3, mesh=mesh,
                       placement="distributed", overlap="off")
        gate["n_exchanges"] = p3.dist.n_exchanges
        gate["per_leg_bytes_sum"] = (
            len(p3.per_leg_collective_bytes) == p3.dist.n_exchanges
            and sum(p3.per_leg_collective_bytes) == p3.collective_bytes)
        info["bench_tune_pencil3"] = gate

        # rank order: this rank's coordinate and the shard it holds
        order = {}
        for axes in (("data", "model"), ("model", "data")):
            shard = tfft.local_shard(torch.arange(WORLD), mesh, axes)
            order["_".join(axes)] = [*mesh.get_coordinate(),
                                     int(shard[0])]
        ranks = [None] * WORLD
        dist.all_gather_object(ranks, order)
        info["order"] = {k: sorted(r[k] for r in ranks) for k in order}

        # tests/test_chaos.py's partial loss: ranks 6 and 7 lost, every
        # rank marks them and re-plans; ranks 0-3 form the shrunk mesh
        from repro_torch.core.resilience import (FaultInjector, FaultPlan,
                                                 clear_events, events,
                                                 meshstate)
        from repro_torch.fft import planner
        tfft.clear_plan_cache()
        mesh_x = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("x",))
        tfft.plan(kind="c2c", n=4096, mesh=mesh_x, placement="distributed")
        inj = FaultInjector(FaultPlan.random(0, 0, rate=0.0,
                                             device_loss=(6, 7)))
        clear_events()
        marked = inj.apply_device_loss(mesh_x)
        p = tfft.plan(kind="c2c", n=4096, mesh=mesh_x,
                      placement="distributed", fallback="degrade")
        member = p.mesh.get_coordinate() is not None
        if member:
            y = p.execute(*(tfft.local_shard(a, p.mesh) for a in x["loss"]))
            order = flat_ranks(p.mesh, mesh_axes(p.mesh))
            parts = []
            for t in y:
                got = [torch.empty_like(t) for _ in order]
                dist.all_gather(got, t, group=p.mesh.get_group())
                parts.append(torch.cat([got[dist.get_group_rank(
                    p.mesh.get_group(), r)] for r in order]).numpy())
            res["loss"] = np.stack(parts)
            refused = None
        else:
            try:
                p.execute(*(a[:1024] for a in x["loss"]))
                refused = False
            except ValueError:
                refused = True
        loss = {"marked": list(marked), "placement": p.placement,
                "devices": int(p.mesh.mesh.numel()),
                "ranks": p.mesh.mesh.tolist(), "member": member,
                "refused": refused,
                "events": [e["reason"] for e in events("plan_downgrade")],
                "stale_keys": sum(1 for k in planner._PLAN_CACHE
                                  if k[1] is not None
                                  and k[1].mesh.numel() == WORLD)}
        meshstate.restore_devices()
        every = [None] * WORLD
        dist.all_gather_object(every, loss)
        info["loss"] = every

        # tests/test_resilience.py's dead mesh: every rank lost, the
        # segmented plan degrades to local
        tfft.clear_plan_cache()
        batch = 4 * WORLD
        tfft.plan(kind="c2c", n=256, batch_shape=(batch,), mesh=mesh_x,
                  placement="segmented")
        dead = {"cached": tfft.cache_info()["entries"]}
        clear_events()
        meshstate.lose_devices(mesh_x.mesh.reshape(-1).tolist())
        try:
            p = tfft.plan(kind="c2c", n=256, batch_shape=(batch,),
                          mesh=mesh_x, placement="segmented",
                          fallback="degrade")
        finally:
            meshstate.restore_devices()
        ev = events("plan_downgrade")
        dead.update(placement=p.placement, mesh=p.mesh is None,
                    events=[{k: e[k] for k in (
                        "reason", "requested_placement",
                        "resolved_placement", "plans_invalidated",
                        "from_devices", "to_devices")} for e in ev],
                    mesh_free=all(k[1] is None for k in planner._PLAN_CACHE))
        res["dead"] = np.stack([t.numpy() for t in p.execute(*x["dead"])])
        info["dead"] = dead

        # the service over the mesh: every rank constructs it, rank 0
        # admits and the others follow
        _serve_on_the_mesh(rank, x, meshes, res, info)
        if rank == 0:
            np.savez(Path(out) / "port.npz", **res)
            (Path(out) / "port.json").write_text(json.dumps(info))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _serve_on_the_mesh(rank, x, meshes, res, info) -> None:
    """The port's service on 8 ranks: the reference's cases, the storm
    with faults, and ranks 6-7 lost between two rounds of requests."""
    import torch.distributed as dist

    import repro_torch.fft as tfft
    from repro_torch.core.resilience import (FaultInjector, FaultPlan,
                                             RetryPolicy, clear_events,
                                             events, meshstate)
    from repro_torch.serve import FftService, loadgen

    reqs = x["svc"].numpy()
    mine = {}  # what each rank saw, gathered at the end

    def recording(service):
        launches = []
        real = service._plan_for

        def recorded(kind, shape, total):
            p = real(kind, shape, total)
            launches.append([total, p.placement, p.num_devices])
            return p

        service._plan_for = recorded
        return launches

    def run_round(service):
        tickets = [service.submit("c2c", *q) for q in reqs]
        service.start()
        return [t.result(timeout=60) for t in tickets]

    for name, verify in SVC_CASES:
        case = f"svc_{name}_{verify}"
        service = FftService(mesh=meshes[name], impl="matfft", device="cpu",
                             coalesce=4, verify=verify, start=False)
        if rank != 0:
            service.close()
            mine[case] = service.stats.batches
            continue
        launches = recording(service)
        outs = run_round(service)
        service.close(drain=True)
        one = FftService(impl="matfft", device="cpu", coalesce=4,
                         verify=verify, start=False)
        want = run_round(one)
        one.close(drain=True)
        res[case] = np.stack([np.stack(o) for o in outs])
        info[case] = {"launches": launches,
                      "one_rank_bitwise": all(loadgen.bitwise_equal(a, b)
                                              for a, b in zip(outs, want))}
        mine[case] = service.stats.batches

    # benchmarks/bench_serve.py's storm, at a small size
    sites = ("serve.admit", "serve.batch", "serve.execute")
    injector = (FaultInjector(FaultPlan.random(
        1407, SVC_STORM_REQUESTS, sites=sites, rate=0.25))
        if rank == 0 else None)
    service = FftService(mesh=meshes["mesh8"], impl="matfft", device="cpu",
                         coalesce=4, queue_depth=40, max_inflight=2,
                         injector=injector, start=False,
                         retry=RetryPolicy(max_attempts=4, base_delay_s=0.0))
    if rank == 0:
        launches = recording(service)
        service.start()
        records = loadgen.drive(service, num_requests=SVC_STORM_REQUESTS,
                                clients=3, seed=1407)
        outcomes = {r.rid: loadgen.classify(r) for r in records}
        service.close(drain=True)
        info["svc_storm"] = {
            "outcomes": dict(Counter(outcomes.values())),
            "idle": service.idle(), "fired": injector.total_fired,
            "placements": dict(Counter(p for _, p, _ in launches)),
            "ok_bitwise": all(
                loadgen.bitwise_equal(r.ticket.value, loadgen.oracle(
                    r.shape, loadgen.request_operands(1407, r.rid, r.shape),
                    impl="matfft", batch_rows=r.ticket.batch_rows,
                    device="cpu"))
                for r in records if outcomes[r.rid] == "ok")}
    else:
        service.close()
    mine["svc_storm"] = service.stats.batches

    # tests/test_chaos.py's partial loss under the service: rank 0 marks
    # ranks 6-7 lost between two rounds; the second round re-plans on the
    # shrunk mesh of ranks 0-3
    tfft.clear_plan_cache()
    clear_events()
    # the round after the loss goes to a running service: a short group
    # waits up to 60 s for company (not 2 ms), so the round's 8 requests
    # leave as two groups of 4 however slowly a loaded host submits them,
    # as the rounds submitted before start() do
    service = FftService(mesh=meshes["mesh8"], impl="matfft", device="cpu",
                         coalesce=4, start=False, max_batch_delay_s=60.0)
    if rank == 0:
        launches = recording(service)
        before = run_round(service)
        marked = FaultInjector(FaultPlan.random(
            0, 0, rate=0.0, device_loss=(6, 7))).apply_device_loss(
                meshes["mesh8"])
        deadline = time.monotonic() + 30
        while (not events("service_degrade")
               and time.monotonic() < deadline):
            time.sleep(0.005)
        after = [service.submit("c2c", *q) for q in reqs]
        after = [t.result(timeout=60) for t in after]
        service.close(drain=True)
        res["svc_loss"] = np.stack([np.stack(o) for o in after])
        info["svc_loss"] = {
            "marked": list(marked), "launches": launches,
            "degrade": [[e["reason"], e["action"]]
                        for e in events("service_degrade")],
            "same_as_before": all(loadgen.bitwise_equal(a, b)
                                  for a, b in zip(before, after))}
        error = None
    else:
        try:
            service.close()
            error = None
        except Exception as e:
            error = repr(e)
    mine["svc_loss"] = {
        "shard_launches": service.stats.batches, "error": error,
        "lost": sorted(meshstate.lost_devices()),
        "downgrades": [e["to_devices"] for e in events("plan_downgrade")]}
    meshstate.restore_devices()
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    info["svc_ranks"] = every


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


# ---------------------------------------------------------------------------
# the N-D pencils: tests/test_pencil_nd.py and tests/test_fft2_plan.py


def _numpy_pencil(x, name):
    kind, key, shape = {r[0]: (r[1], r[2], r[3]) for r in PENCIL_RUNS}[name]
    if kind == "c2c":
        return _split(np.fft.fftn(x[key][0].astype(np.float64)
                                  + 1j * x[key][1]))
    return _split(np.fft.rfftn(x[key].astype(np.float64)))


@pytest.mark.parametrize("name", [r[0] for r in PENCIL_RUNS])
def test_pencil_matches_numpy_and_the_reference(runs, name):
    """Each pencil on 8 gloo ranks within 5e-6 of the reference's on 8
    forced host devices (for r2c, the reference's local rfftn: its r2c
    pencil raises on this JAX, ROADMAP Queue 3) and of numpy's
    fftn/rfftn."""
    ref, port, _, x = runs
    assert port[name].shape == ref[name].shape
    assert _rel_err(port[name], ref[name]) < TOL
    assert _rel_err(port[name], _numpy_pencil(x, name)) < TOL


@pytest.mark.parametrize("name", [r[0] for r in PENCIL_RUNS] + ["pen2_long"])
def test_pencil_bitwise_vs_local_and_between_engines(runs, name):
    """The pencil runs local fftn's axis order on the same kernels: the
    monolithic and the overlapped engines (2 slabs) equal the local plan
    bit for bit (tests/test_pencil_nd.py::test_bitwise_vs_local_fftn,
    ::test_3d_bitwise_vs_local_rfftn, ::test_2d_bitwise_vs_local_rfftn);
    pen2_long's axis 0 (8192) runs axis_pass's transpose fallback, its
    slabs sliced at their offsets."""
    _, _, info, _ = runs
    case = info["pencil"][name]
    assert case["local_bitwise"] and case["engines_bitwise"], case


def test_pencil_exchange_calls(runs):
    """A 2-D pencil runs ONE exchange leg, a 3-D one two: one
    all_to_all_single a plane and leg for the monolithic engine; two
    slabs of D-1 rounds (of the leg's ring) a leg for the overlapped."""
    _, _, info, _ = runs
    pen = info["pencil"]
    assert pen["pen2"]["calls_off"] == {"all_to_all_single": 2}
    assert pen["pen2"]["calls_2"] == {"batch_isend_irecv": 2,
                                      "sends": 2 * (WORLD - 1) * 2,
                                      "rounds": 2 * (WORLD - 1)}
    assert pen["pen3"]["calls_off"] == {"all_to_all_single": 4}
    # leg 1 over "model" (2 ranks), leg 0 over "data" (4 ranks)
    assert pen["pen3"]["calls_2"] == {"batch_isend_irecv": 4,
                                      "sends": 2 * 2 * (1 + 3),
                                      "rounds": 2 * (1 + 3)}
    # r2c: the same legs, then one all_gather a plane for the untangle
    assert pen["pen3_r2c"]["calls_off"] == {"all_to_all_single": 4}


def test_pencil_grid_follows_mesh_axes(runs):
    _, _, info, _ = runs
    pen = info["pencil"]
    assert pen["pen3"]["grid"] == [4, 2] and pen["pen3"]["d"] == 8
    assert pen["pen3"]["n_exchanges"] == 2
    assert pen["pen2"]["grid"] == [8] and pen["pen2"]["n_exchanges"] == 1


def test_pencil_inverse_roundtrip_and_one_build(runs):
    _, _, info, _ = runs
    for name in ("pen3", "pen2", "pen2_long"):
        case = info["pencil"][name]
        assert case["roundtrip"] < 1e-5 and case["builds"] == 1, case


def test_r2c_pencil_is_flop_halved(runs):
    _, _, info, _ = runs
    for name in ("pen3_r2c", "pen2_r2c", "pen2_slice"):
        assert info["pencil"][name]["fast_off"], name
        assert info["pencil"][name]["fast_2"], name


def test_pencil_cost_model_matches_the_reference(runs):
    """hbm_bytes, collective_bytes (total and per leg, exposed too), flops
    and gemm_macs of every pencil plan equal the reference plans'; the
    per-leg bytes sum to the totals; the packed r2c pencil moves half the
    c2c pencil's exchange bytes (tests/test_pencil_nd.py)."""
    ref, _, info, _ = runs
    got = info["pencil_cost"]
    assert got == json.loads(str(ref["pencil_cost"]))
    fields = dict(enumerate(PENCIL_COST))
    for case, row in zip(PENCIL_COST_CASES, got):
        v = {fields[i]: row[i] for i in range(len(row))}
        assert sum(v["per_leg_collective_bytes"]) == \
            v["collective_bytes"][0], case
        assert sum(v["per_leg_exposed_collective_bytes"]) == \
            v["exposed_collective_bytes"][0], case
        assert len(v["per_leg_collective_bytes"]) == len(case[1]) - 1
    half = len(PENCIL_COST_CASES) // 2
    for c2c, r2c in zip(got[:half], got[half:]):
        assert r2c[1][0] * 2 == c2c[1][0]
        assert r2c[5][0] < 0.75 * c2c[5][0] and r2c[6][0] < 0.75 * c2c[6][0]


def test_pencil_plan_one_exchange_leg(runs):
    _, _, info, _ = runs
    legs = info["one_leg"]
    assert legs["off"] == [1, 2 * 4 * 512 * 512, 2 * 4 * 512 * 512]
    assert legs["2"][1] == legs["off"][1] and legs["2"][2] * 2 == legs["2"][1]
    assert legs["1-D"] == 3 * legs["off"][1]


def test_pencil_spec_errors_with_a_mesh(runs):
    _, _, info, _ = runs
    errors = info["pencil_errors"]
    assert errors["axis_count"] and "mesh axes" in errors["axis_count"]
    assert errors["indivisible"] and "axis 1" in errors["indivisible"]


def test_pencil_r2c_slice_path(runs):
    """tests/test_fft2_plan.py's r2c pencil of a 64 x 64 image on 8 ranks:
    the one-sided (64, 33) spectrum, one exchange leg."""
    _, port, info, x = runs
    assert port["pen2_slice"].shape == (2, 64, 33)
    want = _split(np.fft.rfft2(x["pen2_real"].astype(np.float64)))
    assert _rel_err(port["pen2_slice"], want) < TOL
    assert info["pencil"]["pen2_slice"]["n_exchanges"] == 1


def _spec(**kw):
    from repro_torch.fft import spec as tspec
    return tspec.resolve(**{"kind": "c2c", "device": "cpu", **kw})


def _jspec(**kw):
    from repro.fft import spec as jspec
    return jspec.resolve(**{"kind": "c2c", **kw})


@pytest.mark.parametrize("kw,match", [
    (dict(shape=(4, 64)), "axis 0.*not divisible by D"),
    (dict(shape=(64, 4)), "axis 1.*not divisible by D"),
    (dict(shape=(64, 64), num_devices=6), "power-of-two device count"),
    (dict(shape=(8, 8, 8)), "3-D"),
    (dict(shape=SHAPE3, axes=None), "mesh"),
])
def test_pencil_spec_errors(kw, match):
    """tests/test_fft2_plan.py's and tests/test_pencil_nd.py's plan-time
    errors, raised by both packages."""
    kw = {"placement": "distributed", "num_devices": 8, "axes": ("data",),
          **kw}
    for resolve in (_spec, _jspec):
        with pytest.raises(ValueError, match=match):
            resolve(**kw)


def test_pencil_axis0_cap():
    """The reference caps a pencil's leading axes at its 16384 leaf; the
    port at MAX_EARLIER_AXIS, the same length: it accepts every spec the
    reference accepts."""
    from repro_torch.fft import spec as tspec
    kw = dict(placement="distributed", num_devices=8, axes=("data",))
    assert tspec.MAX_EARLIER_AXIS == 1 << 14
    for resolve in (_spec, _jspec):
        assert resolve(shape=(1 << 14, 64), **kw).placement == "distributed"
    with pytest.raises(ValueError, match="MAX_EARLIER_AXIS"):
        _spec(shape=(1 << 15, 64), **kw)
    with pytest.raises(ValueError, match="MAX_LEAF"):
        _jspec(shape=(1 << 15, 64), **kw)


def test_pencil_normalizes_twiddle_knobs():
    kw = dict(shape=(64, 64), placement="distributed", num_devices=8,
              axes=("data",), natural_order=False, fuse_twiddle=True)
    for s in (_spec(**kw), _jspec(**kw)):
        # the pencil has no outer twiddle and is always natural-order
        assert s.natural_order is True and s.fuse_twiddle is False


@pytest.mark.parametrize("args", [
    ((64, 64), 1, 0, None), ((64, 64), 16, 1, 8), ((64, 64), 3, 1, 8),
    ((64, 64), 1, 0, 8), ((4, 64), 1, 0, 8), (1 << 20, 1, 0, 8),
    (1024, 16, 1, None), ((16, 16, 16), 1, 0, 8)])
def test_resolve_placement_2d_matches_the_reference(args):
    from repro.fft.spec import resolve_placement as jplace
    from repro_torch.fft.spec import resolve_placement
    assert resolve_placement(*args) == jplace(*args)


@pytest.mark.parametrize("shape,d,overlap", [
    ((64, 64), 8, "auto"), ((16384, 16384), 8, "auto"), ((64, 64), 8, 4),
    ((64, 64), 8, "off"), (SHAPE3, 8, 2), ((8192, 8192), 1, "auto"),
    ((512, 512, 512), 1, "auto")])
def test_pencil_overlap_resolution_matches_the_reference(shape, d, overlap):
    from repro.core.fft.distributed import resolve_overlap_pencil as jres
    from repro_torch.core.fft.distributed import resolve_overlap_pencil
    grid = (4, 2) if shape == SHAPE3 else (
        (1, 1) if len(shape) == 3 else None)
    assert resolve_overlap_pencil(shape, d, overlap, grid=grid) == \
        jres(shape, d, overlap, grid=grid)


@pytest.mark.parametrize("bad", [0, -1, 3, 16, "weird", 2.5, True])
def test_pencil_overlap_rejects_bad_chunks(bad):
    from repro_torch.core.fft.distributed import resolve_overlap_pencil
    with pytest.raises(ValueError, match="overlap"):
        resolve_overlap_pencil((64, 64), 8, bad)


# ---------------------------------------------------------------------------
# fallback="degrade": tests/test_chaos.py and tests/test_resilience.py


def test_tuner_one_decision_on_eight_ranks(runs):
    """Under a measurer that gives each rank another fastest overlap, every
    rank takes the same knobs (each candidate timed at its slowest rank),
    the tuned plans run without a hang and equal the default plans bit for
    bit, rank 0 alone writes the wisdom (once a spec), and the second plan
    is a wisdom hit on every rank with no measurement."""
    _, _, info, _ = runs
    every = info["tune"]
    for name in ("dist", "pencil3"):
        assert len({json.dumps(r[name]["knobs"]) for r in every}) == 1
        assert len({r[name]["own"] for r in every}) == 4
        for r in every:
            assert r[name]["bitwise_default"], (name, r)
            assert r[name]["measurements"] > 1
            assert r[name]["second_measurements"] == 0
            assert r[name]["wisdom_hits"] == 1 and r[name]["same_again"]
    assert [r["writes"] for r in every] == [2] + [0] * (WORLD - 1)


def test_bench_tune_pencil3d_bitwise_vs_local_fftn(runs):
    """benchmarks/bench_tune.py's third gate on the (4, 2) mesh."""
    _, _, info, _ = runs
    gate = info["bench_tune_pencil3"]
    assert gate == {"bitwise_overlap_off": True, "bitwise_overlap_2": True,
                    "n_exchanges": len(SHAPE3) - 1,
                    "per_leg_bytes_sum": True}


def test_device_loss_degrades_to_shrunk_mesh(runs):
    """Ranks 6 and 7 lost: every rank re-plans on the 4-rank healthy
    sub-mesh, its output within 5e-6 of the reference's on its 4-device
    sub-mesh, one downgrade logged, the stale 8-rank plan gone; the
    ranks left out hold no shard and refuse to execute."""
    ref, port, info, x = runs
    assert json.loads(str(ref["loss_info"])) == [
        "distributed", 4, ["mesh_degraded"]]
    for r, loss in enumerate(info["loss"]):
        assert loss["marked"] == [6, 7]
        assert (loss["placement"], loss["devices"]) == ("distributed", 4)
        assert loss["ranks"] == [0, 1, 2, 3]
        assert loss["events"] == ["mesh_degraded"]
        assert loss["stale_keys"] == 0
        assert loss["member"] == (r < 4)
        assert loss["refused"] == (None if r < 4 else True)
    assert _rel_err(port["loss"], ref["loss"]) < TOL
    assert _rel_err(port["loss"], _split(_numpy_fft(x["loss"]))) < TOL


def test_plan_degrade_falls_back_to_local_on_dead_mesh(runs):
    _, port, info, x = runs
    dead = info["dead"]
    assert dead["cached"] == 1
    assert dead["placement"] == "local" and dead["mesh"]
    assert dead["events"] == [{
        "reason": "mesh_degraded", "requested_placement": "segmented",
        "resolved_placement": "local", "plans_invalidated": 1,
        "from_devices": WORLD, "to_devices": 0}]
    assert dead["mesh_free"]
    assert _rel_err(port["dead"], _split(_numpy_fft(x["dead"]))) < TOL


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(*sys.argv[2:])
    else:
        _worker(int(sys.argv[2]), *sys.argv[3:])


# ---------------------------------------------------------------------------
# the service over the mesh (ROADMAP Queue 1 item 14)


@pytest.mark.parametrize("name,verify", SVC_CASES)
def test_service_on_the_mesh_matches_the_reference(runs, name, verify):
    """The same requests through the reference's service on 8 host devices
    and the port's on 8 ranks: each output within TOL, the same launches at
    the same placements (segmented, or local with the ABFT checksum row),
    and bitwise equal to the port's one-rank service."""
    ref, port, info, x = runs
    case = f"svc_{name}_{verify}"
    for got, want, q in zip(port[case], ref[case], x["svc"]):
        assert _rel_err(got, want) < TOL
        assert _rel_err(got, _split(_numpy_fft(q))) < TOL
    ref_launches = json.loads(str(ref[case + "_launches"]))
    assert [la[:2] for la in info[case]["launches"]] == ref_launches
    rows = 4 * SVC_SHAPE[0] + (verify == "abft")
    assert ref_launches == [[rows, "segmented" if verify == "off"
                             else "local"]] * 2
    assert info[case]["one_rank_bitwise"]


@pytest.mark.parametrize("name,verify", SVC_CASES)
def test_service_followers_run_segmented_shards_only(runs, name, verify):
    _, _, info, _ = runs
    case = f"svc_{name}_{verify}"
    batches = [r[case] for r in info["svc_ranks"]]
    assert batches[0] == 2  # rank 0 counts every launch
    assert batches[1:] == [2 if verify == "off" else 0] * (WORLD - 1)


def test_service_storm_on_eight_ranks(runs):
    """bench_serve's storm with faults: every ok bitwise equal to its
    oracle, every other request classified, drained, followers alive."""
    _, _, info, _ = runs
    storm = info["svc_storm"]
    classified = {"ok", "queue_full", "rate_limit", "inflight_cap",
                  "admit_fault", "closed", "shed", "deadline", "failed"}
    assert sum(storm["outcomes"].values()) == SVC_STORM_REQUESTS
    assert set(storm["outcomes"]) <= classified
    assert storm["outcomes"].get("ok", 0) > 0 and storm["fired"] > 0
    assert storm["ok_bitwise"] and storm["idle"]
    # full batches split over the ranks, singletons on rank 0
    assert storm["placements"].get("segmented", 0) > 0
    assert all(r["svc_storm"] > 0 for r in info["svc_ranks"][1:])


def test_service_rank_loss_degrades_to_the_shrunk_mesh(runs):
    _, port, info, x = runs
    loss = info["svc_loss"]
    assert loss["marked"] == [6, 7]
    assert ["device_loss", "replan_fallback_degrade"] in loss["degrade"]
    rows = 4 * SVC_SHAPE[0]
    assert loss["launches"] == ([[rows, "segmented", WORLD]] * 2
                                + [[rows, "segmented", 4]] * 2)
    assert loss["same_as_before"]
    for got, q in zip(port["svc_loss"], x["svc"]):
        assert _rel_err(got, _split(_numpy_fft(q))) < TOL
    for r, seen in enumerate(info["svc_ranks"]):
        assert seen["svc_loss"]["lost"] == [6, 7]
        if r == 0:
            continue
        # every follower exited cleanly; ranks 1-3 ran both rounds' shards
        assert seen["svc_loss"]["error"] is None
        assert seen["svc_loss"]["shard_launches"] == (4 if r < 4 else 2)
        # each launch after the loss re-planned on the shrunk mesh
        assert seen["svc_loss"]["downgrades"] == [4, 4]
