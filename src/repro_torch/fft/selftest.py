"""Smoke test of the plan-and-execute facade.

    PYTHONPATH=src python -m repro_torch.fft.selftest [--device cuda|cpu]

Plans and runs one case of every placement the port has, on the CUDA card
(the default) or, with ``--device cpu``, through the kernels' plain
versions, each against numpy's float64 FFT within 5e-6 (max |got - want| /
max |want|): the leaf, the level-1 four-step, r2c at both, the stockham
leaf, the N-D local transforms (fft2, rfft2), the out-of-core placement
(in a temporary directory), and on a world-size-1 process group the
segmented placement, both 1-D distributed exchange engines (bitwise equal
to each other) and the 2-D pencil (bitwise equal to the local plan), and
one plan chosen by the autotuner on the analytic model (bitwise equal to
the default plan; its second call a wisdom hit). Each plan runs twice and
must be built once. A process group is created (NCCL on the card, gloo on
the CPU, through a FileStore in the temporary directory) unless one
exists. Exit code 0: every case passed.
"""

from __future__ import annotations

import argparse
import datetime
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import repro_torch.fft as fft_api
from repro_torch.fft.spec import resolve_device

TOL = 5e-6


def _rel_err(got, want) -> float:
    g = (np.asarray(got[0].cpu(), np.float64)
         + 1j * np.asarray(got[1].cpu(), np.float64))
    scale = np.abs(want).max() or 1.0
    return float(np.abs(g - want).max() / scale)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


class _Run:
    """The cases' outcomes: one line each, ``ok`` their conjunction."""

    def __init__(self):
        self.ok = True

    def check(self, name: str, passed: bool, detail: str) -> None:
        self.ok &= passed
        print(f"selftest {name:<26} {'OK' if passed else 'FAIL'} "
              f"({detail})")

    def fft_case(self, name: str, plan, err: float) -> None:
        builds = plan.build_counts["forward"]
        self.check(name, err < TOL and builds == 1,
                   f"err={err:.2e}, builds={builds}")


def _planes(rng, shape):
    return tuple(torch.from_numpy(a) for a in
                 rng.standard_normal((2, *shape)).astype(np.float32))


def _c2c(run: _Run, name: str, plan, x, want):
    y = plan.execute(*x)
    plan.execute(*x)  # a second call must not rebuild
    run.fft_case(name, plan, _rel_err(y, want))
    return y


def _local_cases(run: _Run, rng, device: str) -> None:
    for label, n, rows, impl in (("leaf", 1024, 4, "matfft"),
                                 ("four_step", 1 << 15, 2, "matfft"),
                                 ("stockham", 1024, 4, "stockham")):
        x = _planes(rng, (rows, n))
        p = fft_api.plan(kind="c2c", n=n, batch_shape=(rows,), impl=impl,
                         device=device)
        _c2c(run, f"c2c/{label}", p, x,
             np.fft.fft(x[0].double().numpy() + 1j * x[1].double().numpy()))
    # r2c: K3 at one leaf, and past one leaf the half-length four-step
    for label, n, rows in (("leaf", 1024, 4), ("four_step", 1 << 16, 2)):
        x = torch.from_numpy(rng.standard_normal((rows, n))
                             .astype(np.float32))
        p = fft_api.plan(kind="r2c", n=n, batch_shape=(rows,), device=device)
        y = p.execute_real(x)
        p.execute_real(x)
        run.fft_case(f"r2c/{label}", p,
                     _rel_err(y, np.fft.rfft(x.double().numpy())))
    # N-D local
    x = _planes(rng, (64, 64))
    p = fft_api.plan(kind="c2c", shape=(64, 64), device=device)
    _c2c(run, "c2c/fft2_local", p, x,
         np.fft.fft2(x[0].double().numpy() + 1j * x[1].double().numpy()))
    xr = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    p = fft_api.plan(kind="r2c", shape=(64, 256), device=device)
    y = p.execute_real(xr)
    p.execute_real(xr)
    run.fft_case("r2c/rfft2_local", p,
                 _rel_err(y, np.fft.rfft2(xr.double().numpy())))


def _out_of_core_case(run: _Run, rng, device: str, tmp: Path) -> None:
    from repro_torch.core.fft.outofcore import corner_turn
    from repro_torch.core.pipeline import BlockStore
    n, budget = 1 << 16, 1 << 17  # the operand is 4x the working set
    factors = fft_api.factor_out_of_core(n, budget)
    sig = rng.standard_normal((n, 2)).astype(np.float32)
    store = BlockStore(tmp / "ooc_in", block_bytes=factors.pass1_panel_bytes)
    store.put_bytes(sig.tobytes())
    p = fft_api.plan(kind="c2c", n=n, placement="out_of_core", store=store,
                     work_dir=tmp / "ooc", budget_bytes=budget,
                     device=device)
    p.execute()
    p.merge(tmp / "ooc_merged.bin")
    got = np.fromfile(tmp / "ooc_merged.bin", np.float32).reshape(n, 2)
    s = sig[:, 0].astype(np.float64) + 1j * sig[:, 1]
    want = corner_turn(np.fft.fft(corner_turn(s, p.factors)), p.factors)
    err = float(np.abs(got[:, 0] + 1j * got[:, 1] - want).max()
                / np.abs(want).max())
    run.check("c2c/out_of_core", err < TOL,
              f"err={err:.2e}, {factors.pass1_jobs + factors.pass2_jobs} "
              f"jobs")


def _mesh_cases(run: _Run, rng, device: str) -> None:
    """Segmented, both 1-D distributed engines and the 2-D pencil on a
    one-rank mesh of the current process group."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(torch.device(device).type, (1,),
                            mesh_dim_names=("data",))
    x = _planes(rng, (16, 512))
    p = fft_api.plan(kind="c2c", n=512, batch_shape=(16,), mesh=mesh,
                     placement="segmented")
    _c2c(run, "c2c/segmented", p, x,
         np.fft.fft(x[0].double().numpy() + 1j * x[1].double().numpy()))

    x = _planes(rng, (4096,))
    want = np.fft.fft(x[0].double().numpy() + 1j * x[1].double().numpy())
    outs = []
    for overlap in ("off", 4):
        p = fft_api.plan(kind="c2c", n=4096, mesh=mesh,
                         placement="distributed", overlap=overlap)
        outs.append(_c2c(run, f"c2c/dist_{overlap}", p, x, want))
    run.check("dist overlap==off bitwise", _same(*outs), "both engines")

    x = _planes(rng, (64, 64))
    p = fft_api.plan(kind="c2c", shape=(64, 64), mesh=mesh,
                     placement="distributed", overlap="off")
    y = _c2c(run, "c2c/pencil", p, x, np.fft.fft2(
        x[0].double().numpy() + 1j * x[1].double().numpy()))
    local = fft_api.plan(kind="c2c", shape=(64, 64), device=device)
    run.check("pencil==local bitwise", _same(y, local.execute(*x)),
              f"{p.dist.n_exchanges} exchange leg")
    fft_api.invalidate_mesh(mesh)  # its group ends with the process group


def _tuned_case(run: _Run, rng, device: str, tmp: Path) -> None:
    from repro_torch.fft import tuner
    cfg = tuner.TuneConfig(measurer="analytic")
    kw = dict(kind="c2c", n=1024, batch_shape=(64,), device=device,
              tune=True, wisdom_path=str(tmp / "wisdom.json"),
              tune_config=cfg)
    x = _planes(rng, (64, 1024))
    p = fft_api.plan(**kw)
    y = _c2c(run, "c2c/tuned", p, x,
             np.fft.fft(x[0].double().numpy() + 1j * x[1].double().numpy()))
    default = fft_api.plan(kind="c2c", n=1024, batch_shape=(64,),
                           device=device)
    run.check("tuned==default bitwise", _same(y, default.execute(*x)),
              f"knobs layout={p.spec.layout}, "
              f"overlap={p.spec.overlap}")
    hits = fft_api.cache_info()["wisdom_hits"]
    again = fft_api.plan(**kw)
    run.check("tuned wisdom hit", again is p
              and fft_api.cache_info()["wisdom_hits"] == hits + 1,
              "second plan: no measurement, the cached plan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the CUDA card (default; no card is an error) or "
                         "the kernels' plain versions on the CPU")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    rng = np.random.default_rng(0)
    run = _Run()
    import torch.distributed as dist
    with tempfile.TemporaryDirectory(prefix="repro_torch_selftest_") as d:
        tmp = Path(d)
        _local_cases(run, rng, device)
        _out_of_core_case(run, rng, device, tmp)
        own_group = not dist.is_initialized()
        if own_group:
            dist.init_process_group(
                "nccl" if device.startswith("cuda") else "gloo",
                store=dist.FileStore(str(tmp / "store"), 1), rank=0,
                world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            _mesh_cases(run, rng, device)
        finally:
            if own_group:
                dist.destroy_process_group()
        _tuned_case(run, rng, device, tmp)
    info = fft_api.cache_info()
    print(f"selftest plan cache: {info['misses']} built, {info['hits']} "
          f"hits, {info['wisdom_hits']} wisdom hits")
    return 0 if run.ok else 1


if __name__ == "__main__":
    sys.exit(main())
