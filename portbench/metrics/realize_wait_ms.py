"""The host's wait for a launched call in `AsyncResult.realize`: the mean
host duration of the port's ``repro_torch.fft.realize.wait`` spans (the
call's event synchronised), over their count."""

from portbench import program_spans


def read(run):
    us = program_spans.mean_us(run.get("events"),
                               ("repro_torch.fft.realize.wait",))
    return None if us is None else us * 1e-3
