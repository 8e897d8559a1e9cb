"""Share of the traced window in which no kernel and no copy ran on the
card: one minus the union of the device operations' intervals over the
window."""

from portbench import trace


def read(run):
    events = run.get("events")
    if not events or not any(trace.is_device(e) for e in events):
        return None
    lo, hi = trace.window(events)
    return 100.0 * (1.0 - trace.busy_us(events) / (hi - lo))
