"""The program's own spans in a trace (`repro_torch.spans` in the port):
host events of category "user_annotation" under the port's names, which
the profiler records only where the program has such a span."""

from __future__ import annotations

from portbench import trace


def mean_us(events, names) -> float | None:
    """Mean host duration in microseconds of the spans named in ``names``,
    over their own count; None where the trace has none."""
    durs = [float(e["dur"]) for e in events or ()
            if any(trace.is_span(e, n) for n in names)]
    return sum(durs) / len(durs) if durs else None
