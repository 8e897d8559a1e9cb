"""`repro_torch.fft` — the plan-and-execute FFT facade.

    import repro_torch.fft

    p = repro_torch.fft.plan(kind="c2c", n=1024, batch_shape=(8192,))
    yr, yi = p.execute(xr, xi)          # tables built once, cached
    h = p.execute_async(xr_host, xi_host, donate=True)
    yr_np, yi_np = h.realize()          # the only host wait
    p.hbm_bytes, p.gemm_macs, p.flops   # analytic roofline cost model

This slice runs local 1-D c2c transforms up to MAX_LOCAL_N points on one
device; see ROADMAP.md for the placements and kinds still to port.
"""

from repro_torch.fft.planner import (AsyncResult, ExecutablePlan, cache_info,
                                     clear_plan_cache, plan)
from repro_torch.fft.spec import MAX_LOCAL_N, FftSpec, resolve_placement

__all__ = [
    "AsyncResult",
    "ExecutablePlan",
    "FftSpec",
    "MAX_LOCAL_N",
    "cache_info",
    "clear_plan_cache",
    "plan",
    "resolve_placement",
]
