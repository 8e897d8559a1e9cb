"""The host's time in `AsyncResult.realize`'s copies to host planes: the
mean host duration of the port's ``repro_torch.fft.realize.copy`` spans
(pinned buffers, the synchronous device-to-host copies, the numpy views),
over their count."""

from portbench import program_spans


def read(run):
    us = program_spans.mean_us(run.get("events"),
                               ("repro_torch.fft.realize.copy",))
    return None if us is None else us * 1e-3
