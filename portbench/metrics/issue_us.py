"""The host's cost to issue one call: the mean host duration of the port's
entry spans (`repro_torch.spans`: ``repro_torch.fft.execute``,
``execute_real``, ``execute_inverse``, ``execute_async``), each from the
operand checks down to the last launch, over the count of those spans."""

from portbench import program_spans

ENTRIES = tuple(f"repro_torch.fft.{e}" for e in
                ("execute", "execute_real", "execute_inverse",
                 "execute_async"))


def read(run):
    return program_spans.mean_us(run.get("events"), ENTRIES)
