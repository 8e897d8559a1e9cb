"""Spans at the layer boundaries of the port, on the profiler's clock.

    from repro_torch.spans import span

    with span("repro_torch.fft.rows"):
        ...

While no `torch.profiler` is recording, `span` returns one shared no-op
context manager: no allocation and no torch call, a read of PyTorch's own
flag. While one records (any ``torch.profiler.profile``), it returns
``torch.profiler.record_function(name)``: the span lands in the trace as a
``user_annotation`` event, with a ``gpu_user_annotation`` copy on the
device's timeline, on the clock of the kernel and copy events beside it.
Under ``torch.autograd.profiler.emit_nvtx`` the same spans are NVTX ranges.

The spans of the FFT path, each nested in the one that calls it:

  repro_torch.fft.execute, .execute_real, .execute_inverse, .execute_async
      an entry point of `ExecutablePlan`, from the operand checks to the
      last launch: the host's cost to issue a call
  repro_torch.fft.realize
      `AsyncResult.realize`, holding
    repro_torch.fft.realize.wait   the wait for the call's event
    repro_torch.fft.realize.copy   the copies to host planes
  repro_torch.fft.rows         the contiguous axis's pass (leaf or four-step)
  repro_torch.fft.axis_pass    one earlier axis's pass
  repro_torch.fft.untangle     the r2c untangle, where it is a pass of its own

The spans of the spectral ops (`repro_torch.core.spectral`):

  repro_torch.spectral.power_spectrogram   the entry, holding
    repro_torch.spectral.stft              the entry of `stft`, holding
      repro_torch.spectral.window          the framing and the Hann window
                                           (the frames written out)
      repro_torch.fft.execute_real         the r2c transform of the frames
    repro_torch.spectral.power             |X|^2 of the one-sided bins
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a span while a profiler
    records, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
