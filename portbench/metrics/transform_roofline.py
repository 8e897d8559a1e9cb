"""The transform's share of its roofline on one chip: the least time the
chip needs for its share of a call (`portbench.work.bound_s`) over the
device time of one call's work on the card other than the exchanges: the
port's kernels and everything PyTorch issues around them (its kernels,
device-to-device copies and fills), NCCL's kernels left out."""

from portbench import trace


def read(run):
    events = run.get("events")
    if not events:
        return None
    calls = trace.calls(events)
    work_us = sum(float(e["dur"]) for e in events
                  if trace.is_port_kernel(e) or trace.is_torch_glue(e))
    if not calls or not work_us:
        return None
    return 100.0 * run["bound_s"] * calls / (work_us * 1e-6)
