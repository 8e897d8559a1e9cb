"""Oracles for the FFT kernels, in PyTorch.

``fft_ref``/``ifft_ref`` delegate to ``torch.fft`` (pocketfft on the CPU,
cuFFT on the card): the oracle, and ``impl="ref"``, never the default path.
``four_step_ref`` spells out the Bailey decomposition with plain tensor
operations so the kernels' internal algebra can be checked stage by stage.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft import plan as fft_plan


def fft_ref(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Planar forward FFT along the last axis via torch.fft."""
    y = torch.fft.fft(torch.complex(xr.float(), xi.float()), dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def ifft_ref(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    y = torch.fft.ifft(torch.complex(xr.float(), xi.float()), dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def four_step_ref(xr: torch.Tensor, xi: torch.Tensor, n1: int, n2: int):
    """Four-step DFT of length n = n1*n2 along the last axis.

    Mirrors plan.py's index convention exactly: input i = i1*n2 + i2,
    output o = o2*n1 + o1.
    """
    n = n1 * n2
    if xr.shape[-1] != n:
        raise ValueError(f"last axis {xr.shape[-1]} != n1*n2 = {n}")
    batch = xr.shape[:-1]

    def table(arrays):
        return (torch.from_numpy(a).to(xr.device) for a in arrays)

    w1r, w1i = table(fft_plan.dft_matrix(n1))
    w2r, w2i = table(fft_plan.dft_matrix(n2))
    tr, ti = table(fft_plan.twiddle_table(n1, n2, n))

    # x[i1, i2] with i = i1*n2 + i2
    xr2 = xr.reshape(*batch, n1, n2)
    xi2 = xi.reshape(*batch, n1, n2)

    # A[o1, i2] = sum_i1 x[i1, i2] W_{n1}[i1, o1]
    ein = "...ij,io->...oj"
    ar = torch.einsum(ein, xr2, w1r) - torch.einsum(ein, xi2, w1i)
    ai = torch.einsum(ein, xr2, w1i) + torch.einsum(ein, xi2, w1r)

    # B = A * T (inner twiddle)
    br, bi = _cmul(ar, ai, tr, ti)

    # C[o1, o2] = sum_i2 B[o1, i2] W_{n2}[i2, o2]
    cr = br @ w2r - bi @ w2i
    ci = br @ w2i + bi @ w2r

    # X[o2*n1 + o1] = C[o1, o2]
    return (cr.transpose(-1, -2).reshape(*batch, n),
            ci.transpose(-1, -2).reshape(*batch, n))
