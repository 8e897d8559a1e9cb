"""Plans the planner built during the window (`repro_torch.fft.cache_info`
misses across it): every call after set-up should find its plan cached."""


def read(run):
    misses = run["counters"].get("plan_misses")
    return None if misses is None else float(misses)
