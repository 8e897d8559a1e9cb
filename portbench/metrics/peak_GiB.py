"""Device memory the run held at its peak on the fullest chip
(`torch.cuda.max_memory_allocated`, read by the harness at the window's
close, before the reference runs): the block one card can take."""


def read(run):
    peak = run.get("peak_bytes")
    return peak / 2**30 if peak else None
