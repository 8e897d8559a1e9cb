"""The host's cost to issue one power spectrogram: the mean host duration
of the port's ``repro_torch.spectral.power_spectrogram`` spans
(`repro_torch.spans`), from the entry down to the power's last launch, over
the count of those spans."""

from portbench import program_spans


def read(run):
    return program_spans.mean_us(run.get("events"),
                                 ("repro_torch.spectral.power_spectrogram",))
