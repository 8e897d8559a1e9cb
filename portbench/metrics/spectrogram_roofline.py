"""The power spectrogram's share of its roofline on one chip: the least time
the chip needs for one call (`portbench.spectrogram_work.bound_s`: the
capture read once and the power written once) over the device time of one
call's work: the port's kernels and everything PyTorch issues around them
(the framing and window, the power, device copies and fills). The
configuration is the one under portbench/configs that declares a ``hop``
and whose capture is the run's ``in_bytes``."""

from pathlib import Path

from portbench import spectrogram_work, trace

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def read(run):
    events = run.get("events")
    if not events:
        return None
    config = spectrogram_work.config_of(run.get("in_bytes"), CONFIGS)
    calls = trace.calls(events)
    work_us = sum(float(e["dur"]) for e in events
                  if trace.is_port_kernel(e) or trace.is_torch_glue(e))
    if config is None or not calls or not work_us:
        return None
    return 100.0 * spectrogram_work.bound_s(config) * calls / (work_us * 1e-6)
