"""Share of the device's operation time spent in work that PyTorch itself
issues around the port's kernels: its elementwise, copy and reduction
kernels and device-to-device copies (`trace.is_torch_glue`)."""

from portbench import trace


def read(run):
    events = run.get("events")
    dev = [e for e in events or () if trace.is_device(e)]
    total = sum(float(e["dur"]) for e in dev)
    if not total:
        return None
    glue = sum(float(e["dur"]) for e in dev if trace.is_torch_glue(e))
    return 100.0 * glue / total
