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

The port runs local 1-D c2c and r2c transforms up to MAX_LOCAL_N points on
one device, and one 1-D c2c signal larger than memory out of core; see
ROADMAP.md for the shapes and placements still to port (`rfft2`/`irfft2`
come with the N-D transforms).
"""

from repro_torch.core.fft.outofcore import (OocPlan, OutOfCorePlan,
                                            factor_out_of_core)
from repro_torch.fft.planner import (AsyncResult, ExecutablePlan, cache_info,
                                     clear_plan_cache, plan)
from repro_torch.fft.spec import MAX_LOCAL_N, FftSpec, resolve_placement

__all__ = [
    "AsyncResult",
    "ExecutablePlan",
    "FftSpec",
    "MAX_LOCAL_N",
    "OocPlan",
    "OutOfCorePlan",
    "cache_info",
    "clear_plan_cache",
    "factor_out_of_core",
    "plan",
    "resolve_placement",
]
