"""Spectral ops built on the FFT stack: STFT, FFT convolution, SpectralMixer.

These are the framework-level consumers of the paper's technique:
  * ``stft`` / ``power_spectrogram`` — the signal analyst's workload the
    paper targets (spectrograms over huge capture files), on the r2c
    plans and their kernel K3;
  * ``fft_conv`` — long causal convolution via FFT (only valid for
    time-invariant kernels);
  * ``fft_conv2d`` — 2-D FFT convolution for image filtering, on the
    ``shape=(n0, n1)`` r2c plans;
  * ``spectral_mixer`` — FNet-style token mixing.

Every transform goes through the `repro_torch.fft` plan-and-execute
facade: the plans behind a given frame or pad length are built once in the
process-level plan cache, so a spectrogram job over thousands of identical
blocks uploads its tables once. Each function takes and returns torch
tensors and runs on ``device`` ("cuda" by default, which must be present;
"cpu" runs the kernels' plain versions).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch.fft as fft_api
from repro_torch.fft.spec import resolve_device
from repro_torch.spans import span


@functools.lru_cache(maxsize=None)
def _hann(frame: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * math.pi * np.arange(frame) / frame)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _hann_on(frame: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_hann(frame)).to(device)


def _on(x, device) -> tuple[torch.Tensor, torch.device]:
    dev = resolve_device(device)
    return torch.as_tensor(x).to(dev, torch.float32), dev


def frame_signal(x, frame: int, hop: int, *, device="cuda") -> torch.Tensor:
    """(..., t) -> (..., n_frames, frame) by strided framing (drop tail).
    A view of ``x`` on ``device``; nothing is copied on the device."""
    x, _ = _on(x, device)
    return x.unfold(-1, frame, hop)


def stft(x, frame: int = 1024, hop: int = 512, *, window: bool = True,
         impl: str = "matfft", device="cuda"):
    """Short-time Fourier transform -> planar (..., n_frames, frame//2+1).

    Frames are real, so this rides the r2c fast path: one half-length
    packed transform with the untangle fused in the kernel (K3).
    """
    with span("repro_torch.spectral.stft"):
        x, dev = _on(x, device)
        with span("repro_torch.spectral.window"):
            frames = frame_signal(x, frame, hop, device=dev)
            if window:
                # materializes the frames
                frames = frames * _hann_on(frame, dev)
            else:
                frames = frames.contiguous()
        p = fft_api.plan(kind="r2c", n=frame, batch_shape=frames.shape[:-1],
                         impl=impl, device=dev)
        return p.execute_real(frames)


def power_spectrogram(x, frame: int = 1024, hop: int = 512,
                      **kw) -> torch.Tensor:
    """|stft|^2, (..., n_frames, frame//2+1)."""
    with span("repro_torch.spectral.power_spectrogram"):
        sr, si = stft(x, frame, hop, **kw)
        with span("repro_torch.spectral.power"):
            return sr * sr + si * si


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def fft_conv(x, kernel, *, impl: str = "matfft",
             device="cuda") -> torch.Tensor:
    """Causal 1-D convolution of (..., t) with (t_k,) via FFT, O(t log t).

    Zero-padded to the next power of two >= t + t_k so the circular
    convolution equals the linear one on the first t samples.
    """
    x, dev = _on(x, device)
    kernel, _ = _on(kernel, dev)
    t = x.shape[-1]
    tk = kernel.shape[-1]
    n = _next_pow2(t + tk)
    xp = F.pad(x, (0, n - t))
    kp = F.pad(kernel, (0, n - tk))
    # both operands are real: multiply one-sided spectra (conjugate
    # symmetry survives the product) and invert with the r2c plan's
    # inverse — every transform runs at half length
    px = fft_api.plan(kind="r2c", n=n, batch_shape=tuple(xp.shape[:-1]),
                      impl=impl, device=dev)
    pk = fft_api.plan(kind="r2c", n=n, batch_shape=tuple(kp.shape[:-1]),
                      impl=impl, device=dev)
    xr, xi = px.execute_real(xp)
    kr, ki = pk.execute_real(kp)
    pr = xr * kr - xi * ki
    pi = xr * ki + xi * kr
    yr = px.execute_inverse(pr, pi)
    return yr[..., :t]


def fft_conv2d(x, kernel, *, impl: str = "matfft",
               device="cuda") -> torch.Tensor:
    """2-D convolution of (..., h, w) images with a (kh, kw) filter via the
    2-D FFT plans (image filtering, O(hw log hw)).

    Both operands are real, so both transforms ride the r2c fast path
    (packed contiguous axis, one N-D untangle after the leading axis):
    multiply the one-sided 2-D spectra — conjugate symmetry survives the
    pointwise product — and invert with the r2c plan's inverse.
    Zero-padded to the next powers of two >= h + kh, w + kw so the
    circular convolution equals the linear one on the leading h x w
    window (the top-left alignment of `fft_conv`).
    """
    x, dev = _on(x, device)
    kernel, _ = _on(kernel, dev)
    h, w = x.shape[-2:]
    kh, kw = kernel.shape[-2:]
    n0, n1 = _next_pow2(h + kh), _next_pow2(w + kw)
    # F.pad writes new contiguous tensors: K3 reads their rows as float2
    xp = F.pad(x, (0, n1 - w, 0, n0 - h))
    kp = F.pad(kernel, (0, n1 - kw, 0, n0 - kh))
    px = fft_api.plan(kind="r2c", shape=(n0, n1),
                      batch_shape=tuple(xp.shape[:-2]), impl=impl,
                      device=dev)
    pk = fft_api.plan(kind="r2c", shape=(n0, n1),
                      batch_shape=tuple(kp.shape[:-2]), impl=impl,
                      device=dev)
    xr, xi = px.execute_real(xp)
    kr, ki = pk.execute_real(kp)
    pr = xr * kr - xi * ki
    pi = xr * ki + xi * kr
    yr = px.execute_inverse(pr, pi)
    return yr[..., :h, :w]


def spectral_mixer(x, *, impl: str = "matfft",
                   device="cuda") -> torch.Tensor:
    """FNet token mixing: Re(FFT_seq(FFT_hidden(x))) for (..., seq, d).

    Requires seq and d to be powers of two; callers pad.
    """
    x, dev = _on(x, device)
    z = torch.zeros_like(x)
    p_hidden = fft_api.plan(kind="c2c", n=x.shape[-1],
                            batch_shape=tuple(x.shape[:-1]), impl=impl,
                            device=dev)
    hr, hi = p_hidden.execute(x, z)  # over d
    hr = hr.transpose(-1, -2).contiguous()
    hi = hi.transpose(-1, -2).contiguous()
    p_seq = fft_api.plan(kind="c2c", n=hr.shape[-1],
                         batch_shape=tuple(hr.shape[:-1]), impl=impl,
                         device=dev)
    sr, _ = p_seq.execute(hr, hi)  # over seq
    return sr.transpose(-1, -2)
