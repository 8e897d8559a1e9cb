"""Execution bodies behind `repro_torch.fft` plans: the level-0/1 transform
code, plain functions over planar float32 tensors that drive the leaf
kernels (`kernels/fft/matfft.py`, `kernels/fft/stockham.py`).

Hierarchy (mirrors the paper's block decomposition):

  level 0  (shared memory)  matfft kernel, n <= plan.MAX_LEAF
  level 1  (device memory)  four-step n = n1*n2, leaf = level 0, with the
                            outer twiddle FUSED into the first pass's
                            epilogue
  level 2  (device memory)  four-step n = n1*n2 with n2 > MAX_LEAF: the
                            second pass is itself a level-1 four-step

The ``layout`` option selects how level-1 pass boundaries move data:

  "zero_copy" (default)  the column-strided kernel (`matfft_cols`) reads
                         and writes the natural buffers directly; no
                         transposed tensor is ever materialized
  "copy"                 the reshape + transpose path, kept as the measured
                         baseline and as the path of non-matfft leaf impls

Every function runs on the device its operands lie on.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fft import plan as fft_plan
from repro_torch.kernels.fft import ref as fft_ref
from repro_torch.kernels.fft.matfft import (matfft, matfft_cols, outer_twiddle,
                                            rfft_leaf, rfft_pack_leaf,
                                            rfft_twiddle,
                                            untangle_half_spectrum)
from repro_torch.kernels.fft.stockham import stockham_fft

Planar = tuple[torch.Tensor, torch.Tensor]


def _periodic(yr, yi, epilogue) -> Planar:
    """Multiply row r of (rows, n) planes by row r % period of a table."""
    er, ei = epilogue
    idx = torch.arange(yr.shape[0], device=yr.device) % er.shape[0]
    er, ei = er[idx], ei[idx]
    return yr * er - yi * ei, yr * ei + yi * er


def _leaf(xr, xi, impl: str, epilogue=None) -> Planar:
    if impl == "matfft":
        return matfft(xr, xi, epilogue=epilogue)
    if impl == "stockham":
        yr, yi = stockham_fft(xr, xi)
        if epilogue is None:
            return yr, yi
        return _periodic(yr, yi, epilogue)
    if impl == "ref":
        yr, yi = fft_ref.fft_ref(xr, xi)
        if epilogue is None:
            return yr, yi
        return _periodic(yr, yi, epilogue)
    raise ValueError(f"unknown fft impl {impl!r}")


# ---------------------------------------------------------------------------
# the shared axis-pass primitive: the level-1 four-step is a chain of these


def axis_pass(xr: torch.Tensor, xi: torch.Tensor, view, *,
              out_major: str = "row", epilogue: Planar | None = None,
              impl: str = "matfft", layout: str = "zero_copy") -> Planar:
    """FFT along the MIDDLE axis of a planar ``view = (B, L, C)`` reshape.

    ``out_major="row"`` returns (B*C, L) with row index b*C + c;
    ``out_major="col"`` returns (B, L, C) — the result written back in
    column order, so a chain of passes stays transpose-free.
    ``epilogue`` is a planar (C, L) table multiplied into output row
    (b, c) (the four-step's outer twiddle).

    layout="zero_copy" + impl="matfft" runs the column-strided kernel
    (`matfft_cols`) when L is one leaf; anything else materializes a
    transpose around the row-major transform (the measured "copy"
    baseline, and the level-2 second pass).
    """
    B, L, C = view
    xr3 = xr.reshape(B, L, C)
    xi3 = xi.reshape(B, L, C)
    if (layout == "zero_copy" and impl == "matfft" and L > 1
            and fft_plan.is_pow2(C) and fft_plan.make_plan(L).levels == 1):
        return matfft_cols(xr3, xi3, out_major=out_major, epilogue=epilogue)
    # fallback: materialize the transpose; columns become batch rows
    xrt = xr3.transpose(1, 2).reshape(B * C, L)
    xit = xi3.transpose(1, 2).reshape(B * C, L)
    yr, yi = fft(xrt, xit, impl=impl, layout=layout)
    if epilogue is not None:
        er, ei = epilogue
        er, ei = er.repeat(B, 1), ei.repeat(B, 1)
        yr, yi = yr * er - yi * ei, yr * ei + yi * er
    if out_major == "col":
        return (yr.reshape(B, C, L).transpose(1, 2).contiguous(),
                yi.reshape(B, C, L).transpose(1, 2).contiguous())
    return yr, yi


def four_step_zero_copy(xr: torch.Tensor, xi: torch.Tensor, n1: int, n2: int,
                        *, impl: str = "matfft") -> Planar:
    """Level-1 four-step as two shared axis passes.

    Pass 1 transforms the n1-axis of the (rows, n1, n2) view with the outer
    twiddle W_N^{o1*i2} fused into the store (row-major out); pass 2
    transforms the n2-axis of the resulting (rows, n2, n1) view with a
    column-major store — which IS the o2-major final order. No transposed
    tensor is materialized: 4 traversals of the data in all
    (plan.fft_hbm_bytes). When n2 exceeds one leaf (level 2), pass 2 is a
    level-1 four-step between two materialized transposes.
    """
    rows, n = xr.shape
    if n != n1 * n2:
        raise ValueError(f"row length {n} != n1*n2 = {n1 * n2}")
    # pass-1 output row (b, i2) is multiplied by T^T[i2, :]: a periodic
    # (n2, n1) table, no O(batch*n) twiddle tensor
    epi = outer_twiddle(n1, n2, xr.device)
    ar, ai = axis_pass(xr, xi, (rows, n1, n2), out_major="row", epilogue=epi,
                       impl=impl)  # (rows*n2, n1), row (b, i2)
    cr, ci = axis_pass(ar, ai, (rows, n2, n1), out_major="col",
                       impl=impl)  # (rows, n2, n1) = [b, o2, o1]
    return cr.reshape(rows, n), ci.reshape(rows, n)


def fft(xr: torch.Tensor, xi: torch.Tensor, *, impl: str = "matfft",
        layout: str = "zero_copy") -> Planar:
    """Batched forward FFT along the last axis of planar float32 tensors.

    Any leading batch shape; the last-axis length must be a power of two up
    to MAX_LEAF**3.
    """
    if layout not in ("zero_copy", "copy"):
        raise ValueError(f"unknown layout {layout!r}")
    batch_shape, n = xr.shape[:-1], xr.shape[-1]
    if n == 1:
        return xr, xi
    fft_plan.log2i(n)
    xr2 = xr.reshape(-1, n).contiguous()
    xi2 = xi.reshape(-1, n).contiguous()
    p = fft_plan.make_plan(n)
    if p.levels == 1:
        yr, yi = _leaf(xr2, xi2, impl)
    else:
        yr, yi = _four_step(xr2, xi2, p.n1, p.n2, impl, layout)
    return yr.reshape(*batch_shape, n), yi.reshape(*batch_shape, n)


def _four_step(xr, xi, n1: int, n2: int, impl: str,
               layout: str = "zero_copy") -> Planar:
    """Level-1 four-step: two batched leaf passes.

    layout="zero_copy" (matfft only): both passes are column-strided kernel
    calls over free reshapes of the same buffers (four_step_zero_copy).

    layout="copy": three reshape + transpose copies around two row-major
    passes, each a full round trip through device memory. Pass 1 is a
    leaf and still fuses the outer twiddle into the leaf epilogue as the
    periodic (n2, n1) table; pass 2 is a leaf, or a level-1 four-step when
    n2 > MAX_LEAF.
    """
    rows, n = xr.shape
    if layout == "zero_copy" and impl == "matfft":
        return four_step_zero_copy(xr, xi, n1, n2, impl=impl)
    epi = outer_twiddle(n1, n2, xr.device)

    def to_cols(a):  # (rows, n1*n2) -> (rows*n2, n1)
        return a.reshape(rows, n1, n2).transpose(1, 2).reshape(rows * n2, n1)

    ar, ai = _leaf(to_cols(xr), to_cols(xi), impl, epilogue=epi)

    def to_rows(a):  # (rows*n2, n1) -> (rows*n1, n2)
        return a.reshape(rows, n2, n1).transpose(1, 2).reshape(rows * n1, n2)

    cr, ci = fft(to_rows(ar), to_rows(ai), impl=impl, layout=layout)

    def out_order(a):  # rows (b, o1), cols o2 -> flat o = o2*n1 + o1
        return a.reshape(rows, n1, n2).transpose(1, 2).reshape(rows, n)

    return out_order(cr), out_order(ci)


def fft_cols(xr: torch.Tensor, xi: torch.Tensor, *, impl: str = "matfft",
             layout: str = "zero_copy", out_major: str = "row") -> Planar:
    """FFT each COLUMN of planar (L, C) tensors.

    Returns (C, L) row-major for ``out_major="row"`` or (L, C)
    column-major for ``out_major="col"``: semantically ``fft(xr.T, xi.T)``,
    but on the zero-copy path the column-strided kernel reads the operand
    in place and writes the requested layout directly. A thin wrapper over
    `axis_pass` with a B=1 view.
    """
    L, C = xr.shape
    yr, yi = axis_pass(xr, xi, (1, L, C), out_major=out_major, impl=impl,
                       layout=layout)
    if out_major == "col":
        return yr.reshape(L, C), yi.reshape(L, C)
    return yr, yi


def ifft(xr: torch.Tensor, xi: torch.Tensor, **kw) -> Planar:
    """Inverse FFT via the conjugation identity: ifft(x) = conj(fft(conj(x)))/n."""
    n = xr.shape[-1]
    yr, yi = fft(xr, -xi, **kw)
    return yr / n, -yi / n


# ---------------------------------------------------------------------------
# real-input transforms: n reals packed as n/2 complex points


def rfft(x: torch.Tensor, *, impl: str = "matfft",
         layout: str = "zero_copy") -> Planar:
    """Real-input FFT along the last axis; returns the planar one-sided
    spectrum (n//2 + 1 bins).

    Fast path (impl="matfft", n >= 4): the n real samples are read as n/2
    complex points and one half-length transform runs. While n/2 is one
    leaf (n <= 2*MAX_LEAF = 8192) that is one K3 launch, untangle fused in
    its store; above it the rows are packed on the device, the half-length
    c2c path runs (K1/K2), and `untangle_half_spectrum` runs as torch ops
    after it. Otherwise: the full complex transform, sliced.
    """
    n = x.shape[-1]
    x = x.to(torch.float32)
    if n < 4 or impl != "matfft":
        yr, yi = fft(x, torch.zeros_like(x), impl=impl, layout=layout)
        return yr[..., : n // 2 + 1], yi[..., : n // 2 + 1]
    fft_plan.log2i(n)
    m = n // 2
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, n).contiguous()
    if fft_plan.make_plan(m).levels == 1:
        yr, yi = rfft_leaf(x2)
    else:
        # bin k pairs with bin m - k, which a level-1 pass puts in another
        # leaf, so the untangle runs after the whole half-length transform
        z = x2.reshape(-1, m, 2)
        zr, zi = fft(z[..., 0], z[..., 1], impl=impl, layout=layout)
        yr, yi = untangle_half_spectrum(zr, zi, *rfft_twiddle(n, x.device))
    return yr.reshape(*batch_shape, m + 1), yi.reshape(*batch_shape, m + 1)


def irfft(yr: torch.Tensor, yi: torch.Tensor, *, impl: str = "matfft",
          layout: str = "zero_copy") -> torch.Tensor:
    """Inverse of rfft: one-sided (..., n//2 + 1) spectrum -> real (..., n).

    Runs the packing in reverse: re-entangle the even/odd sub-spectra into
    a half-length spectrum, one half-length inverse transform, then
    interleave.
    """
    m = yr.shape[-1] - 1
    n = 2 * m
    if m < 2 or impl != "matfft":
        # mirror to the full spectrum, full inverse transform
        fr = torch.cat([yr, torch.flip(yr[..., 1:-1], (-1,))], dim=-1)
        fi = torch.cat([yi, -torch.flip(yi[..., 1:-1], (-1,))], dim=-1)
        zr, _ = ifft(fr, fi, impl=impl, layout=layout)
        return zr
    # E[k] = (X[k] + conj(X[m-k]))/2 ; O[k] = conj(v[k])*(X[k] - conj(X[m-k]))/2
    xr_, xi_ = yr[..., :m], yi[..., :m]
    # conj(X[m-k]), k = 0..m-1
    pr, pi = torch.flip(yr[..., 1:], (-1,)), -torch.flip(yi[..., 1:], (-1,))
    er, ei = 0.5 * (xr_ + pr), 0.5 * (xi_ + pi)
    dr, di = 0.5 * (xr_ - pr), 0.5 * (xi_ - pi)
    vr, vi = rfft_twiddle(n, yr.device)
    our = vr * dr + vi * di  # conj(v) * D
    oui = vr * di - vi * dr
    # Z = E + i*O, z = IDFT_m(Z), x[2k] = Re z[k], x[2k+1] = Im z[k]
    zr, zi = ifft(er - oui, ei + our, impl=impl, layout=layout)
    return torch.stack([zr, zi], dim=-1).reshape(*zr.shape[:-1], n)


def rfft_pack_pass(x2: torch.Tensor, n_last: int, *, impl: str = "matfft",
                   layout: str = "zero_copy") -> Planar:
    """Contiguous-axis pass of the N-D real-input path: (rows, n_last) real
    rows -> (rows, n_last//2) RAW packed half spectrum (no untangle)."""
    m = n_last // 2
    if fft_plan.make_plan(m).levels == 1:
        return rfft_pack_leaf(x2.contiguous())
    # the half transform is level-1: pack on the device first (one extra
    # round trip)
    z = x2.reshape(x2.shape[0], m, 2)
    return fft(z[..., 0], z[..., 1], impl=impl, layout=layout)
