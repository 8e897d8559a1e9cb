"""DEPRECATED per-call FFT entry points — thin shims over `repro_torch.fft`.

These functions predate the plan-and-execute facade. Each call resolves a
spec, fetches the cached `ExecutablePlan` from the process-level plan
cache (`repro_torch.fft.plan`) and executes it, so repeat calls with the
same shape and options reuse the plan's tables and kernels.

New code should hold a plan directly:

    p = repro_torch.fft.plan(kind="c2c", n=n, batch_shape=batch)
    yr, yi = p.execute(xr, xi)

The JAX package's shims take ``interpret=``; here ``device=`` takes its
place, by default the operand's device (a torch tensor's, else "cuda").
The JAX package also inlines the plan's raw executor when a shim is
called under an outer `jax.jit` trace, so traced programs read as
reshapes and pallas_calls; PyTorch traces nothing here, so there is no
counterpart, and `fft_jit` is `fft`. `fft_cols` and the
``global_twiddle`` path are layout-level internals of
`core/fft/distributed.py` and delegate straight to the executors.
"""

from __future__ import annotations

import warnings

import torch

import repro_torch.fft as fft_api
from repro_torch.fft import executors as _ex

Planar = tuple[torch.Tensor, torch.Tensor]

# one DeprecationWarning per public entry point per process; the internal
# global_twiddle path never warns (nothing for its caller to migrate)
_WARNED: set = set()


def _warn_deprecated(name: str) -> None:
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"repro_torch.kernels.fft.ops.{name} is deprecated; plan once with "
        f"repro_torch.fft.plan(...) and reuse the returned ExecutablePlan "
        f"(execute/execute_real/execute_inverse)",
        DeprecationWarning, stacklevel=3)


def _reset_deprecation_warnings() -> None:
    """Test hook: make each entry point warn again."""
    _WARNED.clear()


def _device(x, device):
    if device is not None:
        return device
    return x.device if isinstance(x, torch.Tensor) else "cuda"


def fft(xr, xi, *, impl: str = "matfft", device=None, global_twiddle=None,
        layout: str = "zero_copy") -> Planar:
    """Deprecated shim: batched forward FFT along the last axis.

    See `repro_torch.fft.plan(kind="c2c", ...)`.
    """
    if global_twiddle is not None:
        return _ex.fft(xr, xi, impl=impl, global_twiddle=global_twiddle,
                       layout=layout)
    _warn_deprecated("fft")
    p = fft_api.plan(kind="c2c", n=xr.shape[-1],
                     batch_shape=tuple(xr.shape[:-1]), layout=layout,
                     impl=impl, device=_device(xr, device))
    return p.execute(xr, xi)


def fft_cols(xr, xi, *, impl: str = "matfft", device=None,
             global_twiddle=None, layout: str = "zero_copy") -> Planar:
    """Deprecated shim: FFT each COLUMN of planar (L, C) tensors, (C, L)
    row-major out. Layout-level internal (distributed pass boundaries);
    delegates to `repro_torch.fft.executors.fft_cols` on the operands'
    device (``device`` moves them first)."""
    if device is not None:
        xr, xi = (torch.as_tensor(a).to(device) for a in (xr, xi))
    return _ex.fft_cols(xr, xi, impl=impl, global_twiddle=global_twiddle,
                        layout=layout)


def ifft(xr, xi, *, impl: str = "matfft", device=None,
         layout: str = "zero_copy") -> Planar:
    """Deprecated shim: inverse FFT. See `ExecutablePlan.execute_inverse`."""
    _warn_deprecated("ifft")
    p = fft_api.plan(kind="c2c", n=xr.shape[-1],
                     batch_shape=tuple(xr.shape[:-1]), layout=layout,
                     impl=impl, device=_device(xr, device))
    return p.execute_inverse(xr, xi)


def fft_c64(x, **kw) -> torch.Tensor:
    """complex64 convenience wrapper (deprecated shim)."""
    x = torch.as_tensor(x)
    yr, yi = fft(x.real.to(torch.float32).contiguous(),
                 x.imag.to(torch.float32).contiguous(), **kw)
    return torch.complex(yr, yi)


def ifft_c64(x, **kw) -> torch.Tensor:
    x = torch.as_tensor(x)
    yr, yi = ifft(x.real.to(torch.float32).contiguous(),
                  x.imag.to(torch.float32).contiguous(), **kw)
    return torch.complex(yr, yi)


def rfft(x, *, impl: str = "matfft", device=None,
         layout: str = "zero_copy") -> Planar:
    """Deprecated shim: real-input FFT, planar one-sided spectrum.

    See `repro_torch.fft.plan(kind="r2c", ...)` /
    `ExecutablePlan.execute_real`.
    """
    _warn_deprecated("rfft")
    dev = _device(x, device)
    x = torch.as_tensor(x).to(torch.float32)
    if x.shape[-1] < 2:
        # degenerate n=1 predates the facade's r2c domain (n >= 2)
        return _ex.rfft(x.to(dev), impl=impl, layout=layout)
    p = fft_api.plan(kind="r2c", n=x.shape[-1],
                     batch_shape=tuple(x.shape[:-1]), layout=layout,
                     impl=impl, device=dev)
    return p.execute_real(x)


def irfft(yr, yi, *, impl: str = "matfft", device=None,
          layout: str = "zero_copy") -> torch.Tensor:
    """Deprecated shim: inverse of rfft, one-sided spectrum -> real signal."""
    _warn_deprecated("irfft")
    n = 2 * (yr.shape[-1] - 1)
    dev = _device(yr, device)
    if n < 2:
        # degenerate 1-bin spectrum predates the facade's r2c domain
        return _ex.irfft(*(torch.as_tensor(a).to(dev) for a in (yr, yi)),
                         impl=impl, layout=layout)
    p = fft_api.plan(kind="r2c", n=n, batch_shape=tuple(yr.shape[:-1]),
                     layout=layout, impl=impl, device=dev)
    return p.execute_inverse(yr, yi)


fft_jit = fft
