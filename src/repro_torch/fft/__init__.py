"""`repro_torch.fft` — the plan-and-execute FFT facade.

    import repro_torch.fft

    p = repro_torch.fft.plan(kind="c2c", n=1024, batch_shape=(8192,))
    yr, yi = p.execute(xr, xi)          # tables built once, cached
    h = p.execute_async(xr_host, xi_host, donate=True)
    yr_np, yi_np = h.realize()          # the only host wait
    p.hbm_bytes, p.gemm_macs, p.flops   # analytic roofline cost model

    r = repro_torch.fft.plan(kind="r2c", n=1024, batch_shape=(8192,))
    sr, si = r.execute_real(x)          # one-sided (8192, 513) spectrum
    x_back = r.execute_inverse(sr, si)
    r.fused_untangle                    # resolved strategy, inspectable

    o = repro_torch.fft.plan(kind="c2c", n=1 << 29,
                             placement="out_of_core", store=store,
                             work_dir=work, budget_bytes=256 << 20)
    stats = o.execute()                 # two streamed passes, resumable
    o.merge(work / "merged.bin")        # spectrum in transposed order

    q = repro_torch.fft.plan(kind="r2c", shape=(4096, 4096),
                             batch_shape=(8,))
    sr, si = q.execute_real(images)     # (8, 4096, 2049) one-sided
    yr, yi = repro_torch.fft.fft2(xr, xi)   # numpy.fft.fft2 conventions

    # SPMD over a process group: every rank plans the same global spec
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    d = repro_torch.fft.plan(kind="c2c", n=1 << 30, mesh=mesh,
                             placement="distributed", overlap=4)
    yr, yi = d.execute(local_shard(xr, mesh), local_shard(xi, mesh))
    v = repro_torch.fft.plan(kind="c2c", shape=(512, 512, 512), mesh=mesh2,
                             placement="distributed")   # a (d0, d1) mesh
    yr, yi = v.execute(pencil_shard(xr, mesh2), pencil_shard(xi, mesh2))
    repro_torch.fft.plan(..., mesh=mesh, fallback="degrade")  # lost ranks

    # measured plan choice, kept as wisdom: a second process measures
    # nothing (cache_info()["wisdom_hits"])
    t = repro_torch.fft.plan(kind="c2c", n=1 << 16, batch_shape=(512,),
                             tune=True, wisdom_path="wisdom.json")
    t.spec.layout, t.spec.overlap        # the winner's knobs

The port runs local c2c and r2c transforms of 1 to 3 axes on one device
(the contiguous axis up to MAX_LOCAL_N points, earlier axes up to
MAX_EARLIER_AXIS), with `fft2`/`ifft2`/`rfft2`/`irfft2` over the trailing
two axes; batches of them split over the ranks of a `DeviceMesh`
(segmented); one 1-D c2c signal split over the ranks (distributed), or
one 2-D/3-D c2c or r2c volume (the pencil: its leading axes over the
rank grid, ndim-1 exchanges); and one 1-D c2c signal larger than memory
out of core. ``fallback="degrade"`` re-plans around ranks marked lost in
`repro_torch.core.resilience.meshstate`. `repro_torch.serve` puts a
fault-tolerant dynamic-batching service in front of these plans.
``python -m repro_torch.fft.selftest`` plans and runs one case of each
placement.

Spans (`repro_torch.spans`): under any ``torch.profiler.profile`` the
path records ``repro_torch.fft.execute``, ``.execute_real``,
``.execute_inverse`` and ``.execute_async`` (an entry point, from its
operand checks to its last launch), ``repro_torch.fft.realize`` holding
``.realize.wait`` (the event's wait) and ``.realize.copy`` (the copies to
host planes), and the executor passes ``repro_torch.fft.rows`` (the
contiguous axis), ``.axis_pass`` (an earlier axis) and ``.untangle`` (the
r2c untangle where it is a pass of its own); ``prof.export_chrome_trace``
writes them beside the kernels. With no profiler recording they cost a
flag read.
"""

from repro_torch.core.fft.distributed import (DistPlan, PencilPlan,
                                              distributed_fft,
                                              distributed_ifft, local_shard,
                                              pencil_shard)
from repro_torch.core.fft.outofcore import (OocPlan, OutOfCorePlan,
                                            factor_out_of_core)
from repro_torch.fft.planner import (AsyncResult, ExecutablePlan, cache_info,
                                     clear_plan_cache, fft2, ifft2,
                                     invalidate_mesh, irfft2, plan, rfft2)
from repro_torch.fft.spec import (MAX_EARLIER_AXIS, MAX_LOCAL_N, FftSpec,
                                  resolve_placement)
from repro_torch.fft.tuner import (TuneConfig, TuneReport, WisdomStore,
                                   reset_tune_stats, tune_stats)

__all__ = [
    "AsyncResult",
    "DistPlan",
    "ExecutablePlan",
    "FftSpec",
    "MAX_EARLIER_AXIS",
    "MAX_LOCAL_N",
    "OocPlan",
    "OutOfCorePlan",
    "PencilPlan",
    "cache_info",
    "clear_plan_cache",
    "distributed_fft",
    "distributed_ifft",
    "factor_out_of_core",
    "fft2",
    "ifft2",
    "invalidate_mesh",
    "irfft2",
    "local_shard",
    "pencil_shard",
    "plan",
    "reset_tune_stats",
    "resolve_placement",
    "rfft2",
    "TuneConfig",
    "TuneReport",
    "tune_stats",
    "WisdomStore",
]
