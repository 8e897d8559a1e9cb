"""The plain reference of the power spectrogram: framing, the periodic Hann
window and the one-sided DFT by their definitions, in plain PyTorch.

    from plain_spectrogram import stft, power_spectrogram

    re, im = stft(x, 1024, 512)            # float64 planes
    p = power_spectrogram(x, 1024, 512)    # Re^2 + Im^2, float64

Nothing of the program and nothing of JAX: no batching, no kernel, no plan
and no cache. Frame f is ``x[hop f : hop f + frame]`` (a tail shorter than a
frame is dropped), the window is 0.5 - 0.5 cos(2 pi k / frame), and bin m of
a frame is sum_k w[k] x[k] exp(-2 pi i (k m mod frame) / frame), the index
product reduced exactly in integers before the angle is taken.

Departures from Welch's method (`scipy.signal.welch`, window 'hann', noverlap
= nperseg // 2): no detrending, no density or spectrum scaling, and no
average over frames; the output is |X|^2 of every frame's one-sided bins,
which is what `repro_torch.core.spectral.power_spectrogram` computes.

``precision``: "float64", the reference, or "tf32", the control: samples,
window and DFT matrix each rounded to TF32 (10 mantissa bits), the precision
a float32 program may not drop to; sums and products stay float64 so that
the rounding of the inputs alone shows.
"""

from __future__ import annotations

import math

import torch

PRECISIONS = ("float64", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits),
    returned as float64."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).double()


def _inputs(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return t.double() if precision == "float64" else to_tf32(t)


def hann(frame: int, precision: str = "float64") -> torch.Tensor:
    """The periodic Hann window of ``frame`` points."""
    k = torch.arange(frame, dtype=torch.float64)
    return _inputs(0.5 - 0.5 * torch.cos(2 * math.pi * k / frame), precision)


def frames_of(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """(n_frames, frame): frame f is x[hop f : hop f + frame]."""
    n_frames = (x.shape[-1] - frame) // hop + 1
    return torch.stack([x[hop * f: hop * f + frame] for f in range(n_frames)])


def dft_one_sided(frame: int, precision: str = "float64"):
    """cos and sin parts of W[k, m] = exp(-2 pi i (k m mod frame) / frame),
    k < frame, m <= frame // 2."""
    k = torch.arange(frame, dtype=torch.int64)[:, None]
    m = torch.arange(frame // 2 + 1, dtype=torch.int64)[None, :]
    angle = ((k * m) % frame).double() * (-2 * math.pi / frame)
    return (_inputs(torch.cos(angle), precision),
            _inputs(torch.sin(angle), precision))


def stft(x, frame: int, hop: int, *, window: bool = True,
         precision: str = "float64"):
    """Planar one-sided spectra (n_frames, frame // 2 + 1) of the real 1-D
    signal ``x``, in float64."""
    # no product on a card may run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = _inputs(torch.as_tensor(x).float(), precision)
    f = frames_of(x, frame, hop)
    if window:
        f = f * hann(frame, precision)
    wr, wi = dft_one_sided(frame, precision)
    return f @ wr, f @ wi


def power_spectrogram(x, frame: int, hop: int, *, window: bool = True,
                      precision: str = "float64") -> torch.Tensor:
    """Re^2 + Im^2 of `stft`, (n_frames, frame // 2 + 1) float64."""
    re, im = stft(x, frame, hop, window=window, precision=precision)
    return re * re + im * im
