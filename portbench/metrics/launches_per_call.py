"""Device kernels in the trace over the calls traced: every launch, the
port's kernels, PyTorch's and NCCL's alike."""

from portbench import trace


def read(run):
    events = run.get("events")
    if not events:
        return None
    calls = trace.calls(events)
    kernels = sum(1 for e in events if trace.is_kernel(e))
    return kernels / calls if calls and kernels else None
