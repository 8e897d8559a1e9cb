"""The plain reference of the power spectrogram, in blocks of frames on the
device: framing and the periodic Hann window by their definitions, and the
one-sided DFT as a product with `portbench.reference`'s DFT matrix (its index
products reduced exactly in integers). Plain PyTorch, nothing of the
program: no kernel, plan or table of it.

Frame f is ``x[hop f : hop f + frame]``, the window 0.5 - 0.5 cos(2 pi k /
frame), and the output Re^2 + Im^2 of each frame's frame // 2 + 1 bins.
Departures from Welch's method (`scipy.signal.welch`, window 'hann',
noverlap = nperseg // 2), the same as the program's: no detrending, no
density or spectrum scaling, no average over frames.

Two precisions, as `portbench.reference`'s: "float64", the reference, and
"tf32", the control (samples, window and DFT matrix rounded to TF32, float32
products with TF32 allowed).
"""

from __future__ import annotations

import math

import torch

from portbench import reference


def hann(frame: int, device, precision: str) -> torch.Tensor:
    k = torch.arange(frame, dtype=torch.float64, device=device)
    w = 0.5 - 0.5 * torch.cos(k * (2 * math.pi / frame))
    return w if precision == "float64" else reference.to_tf32(w.float())


def power(x: torch.Tensor, frame: int, hop: int, f0: int, f1: int,
          precision: str = "float64", cache: dict | None = None):
    """The power of frames f0 .. f1 - 1 of the 1-D capture ``x``,
    (f1 - f0, frame // 2 + 1), in the precision's dtype."""
    cache = {} if cache is None else cache
    key = (frame, x.device, precision)
    if key not in cache:
        cache[key] = (hann(frame, x.device, precision),
                      reference.dft_matrix(frame, frame // 2 + 1, x.device,
                                           precision))
    w, (wr, wi) = cache[key]
    frames = x[hop * f0: hop * (f1 - 1) + frame].unfold(0, frame, hop)
    if precision == "float64":
        windowed = frames.double() * w
    else:
        windowed = reference.to_tf32(frames) * w
    re, im = reference.cmatmul(windowed, None, wr, wi, precision)
    return re * re + im * im


def blocks(n_frames: int, per_block: int):
    """(f0, f1) of consecutive blocks of ``per_block`` frames."""
    for f0 in range(0, n_frames, per_block):
        yield f0, min(f0 + per_block, n_frames)
