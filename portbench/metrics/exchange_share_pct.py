"""Share of the busy time of rank 0's card spent in NCCL's kernels: the
exchanges between chips."""

from portbench import trace


def read(run):
    events = run.get("events")
    if not events:
        return None
    nccl = sum(float(e["dur"]) for e in events if trace.is_nccl(e))
    busy = trace.busy_us(events)
    return 100.0 * nccl / busy if nccl and busy else None
