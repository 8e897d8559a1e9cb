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

N-D transforms (`fftn`, `rfftn` and their inverses) run the contiguous
axis as a batched 1-D transform and every earlier axis as one `axis_pass`
with a column-major store: no outer twiddle, the DFT is separable. An
earlier axis longer than MAX_LEAF (up to the JAX package's 16384, where
it runs one column pass) takes `axis_pass`'s transpose fallback: a
materialized transpose, the level-1 `fft` (two K2 passes) and a
transpose back.

The cross-rank four-step (`core/fft/distributed.py`) runs its two passes
through `fft_cols`: pass 1 with the distributed twiddle fused into the
leaf's store (``global_twiddle``), pass 2's slabs read in place
(``col_offset``/``ncols``).

The ``layout`` option selects how level-1 pass boundaries move data:

  "zero_copy" (default)  the column-strided kernel (`matfft_cols`) reads
                         and writes the natural buffers directly; no
                         transposed tensor is ever materialized
  "copy"                 the reshape + transpose path, kept as the measured
                         baseline and as the path of non-matfft leaf impls

Every function runs on the device its operands lie on.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.fft import plan as fft_plan
from repro_torch.kernels.fft import ref as fft_ref
from repro_torch.kernels.fft.matfft import (apply_global_twiddle, matfft,
                                            matfft_cols, outer_twiddle,
                                            rfft_leaf, rfft_pack_leaf,
                                            rfft_twiddle,
                                            untangle_half_spectrum)
from repro_torch.kernels.fft.stockham import stockham_fft
from repro_torch.spans import span

Planar = tuple[torch.Tensor, torch.Tensor]
# the passes' spans (`repro_torch.spans`)
ROWS = "repro_torch.fft.rows"
AXIS_PASS = "repro_torch.fft.axis_pass"
UNTANGLE = "repro_torch.fft.untangle"


def _periodic(yr, yi, epilogue) -> Planar:
    """Multiply row r of (rows, n) planes by row r % period of a table."""
    er, ei = epilogue
    idx = torch.arange(yr.shape[0], device=yr.device) % er.shape[0]
    er, ei = er[idx], ei[idx]
    return yr * er - yi * ei, yr * ei + yi * er


def _leaf(xr, xi, impl: str, epilogue=None, global_twiddle=None) -> Planar:
    if impl == "matfft":
        return matfft(xr, xi, epilogue=epilogue,
                      global_twiddle=global_twiddle)
    if impl == "stockham":
        yr, yi = stockham_fft(xr, xi)
    elif impl == "ref":
        yr, yi = fft_ref.fft_ref(xr, xi)
    else:
        raise ValueError(f"unknown fft impl {impl!r}")
    if epilogue is not None:
        return _periodic(yr, yi, epilogue)
    if global_twiddle is not None:
        return apply_global_twiddle(yr, yi, *global_twiddle)
    return yr, yi


# ---------------------------------------------------------------------------
# the shared axis-pass primitive: the level-1 four-step is a chain of these


def axis_pass(xr: torch.Tensor, xi: torch.Tensor, view, *,
              out_major: str = "row", epilogue: Planar | None = None,
              global_twiddle: tuple[int, int] | None = None,
              impl: str = "matfft", layout: str = "zero_copy",
              col_offset: int = 0, ncols: int | None = None) -> Planar:
    """FFT along the MIDDLE axis of a planar ``view = (B, L, C)`` reshape,
    or of the aligned column slab [col_offset, col_offset + nc) of it (nc
    = ``ncols``, default every column from ``col_offset`` on).

    ``out_major="row"`` returns (B*nc, L) with row index b*nc + c;
    ``out_major="col"`` returns (B, L, nc) — the result written back in
    column order, so a chain of passes stays transpose-free.
    ``epilogue`` is a planar (C, L) table multiplied into output row
    (b, c) (the four-step's outer twiddle); ``global_twiddle`` = (n_global,
    row_off) multiplies output row r, column o by W_{n_global}^{(row_off +
    r) * o} (the distributed four-step's twiddle). Not both.

    layout="zero_copy" + impl="matfft" runs the column-strided kernel
    (`matfft_cols`, the slab read in place) when L is one leaf; anything
    else slices the slab and materializes a transpose around the row-major
    transform (the measured "copy" baseline, and the level-2 second pass).
    """
    if epilogue is not None and global_twiddle is not None:
        raise ValueError(
            "axis_pass: epilogue and global_twiddle are mutually exclusive")
    B, L, C = view
    xr3 = xr.reshape(B, L, C)
    xi3 = xi.reshape(B, L, C)
    nc = C - col_offset if ncols is None else ncols
    if (layout == "zero_copy" and impl == "matfft" and L > 1
            and fft_plan.is_pow2(C) and fft_plan.is_pow2(nc)
            and fft_plan.make_plan(L).levels == 1):
        return matfft_cols(xr3, xi3, out_major=out_major, epilogue=epilogue,
                           global_twiddle=global_twiddle,
                           col_offset=col_offset, ncols=nc)
    # fallback: slice the slab, materialize the transpose; columns become
    # batch rows
    cols = slice(col_offset, col_offset + nc)
    xrt = xr3[:, :, cols].transpose(1, 2).reshape(B * nc, L)
    xit = xi3[:, :, cols].transpose(1, 2).reshape(B * nc, L)
    yr, yi = fft(xrt, xit, impl=impl, layout=layout,
                 global_twiddle=global_twiddle)
    if epilogue is not None:
        er, ei = epilogue
        er, ei = er[cols].repeat(B, 1), ei[cols].repeat(B, 1)
        yr, yi = yr * er - yi * ei, yr * ei + yi * er
    if out_major == "col":
        return (yr.reshape(B, nc, L).transpose(1, 2).contiguous(),
                yi.reshape(B, nc, L).transpose(1, 2).contiguous())
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
                       impl=impl)  # (rows*n2, n1)
    cr, ci = axis_pass(ar, ai, (rows, n2, n1), out_major="col",
                       impl=impl)  # (rows, n2, n1) = [b, o2, o1]
    return cr.reshape(rows, n), ci.reshape(rows, n)


def fft(xr: torch.Tensor, xi: torch.Tensor, *, impl: str = "matfft",
        layout: str = "zero_copy",
        global_twiddle: tuple[int, int] | None = None) -> Planar:
    """Batched forward FFT along the last axis of planar float32 tensors.

    Any leading batch shape; the last-axis length must be a power of two up
    to MAX_LEAF**3. ``global_twiddle`` = (n_global, row_off) multiplies
    row r, column o of the (rows, n) result by W_{n_global}^{(row_off + r)
    * o}, fused into K1's store (impl "matfft"); one leaf only.
    """
    if layout not in ("zero_copy", "copy"):
        raise ValueError(f"unknown layout {layout!r}")
    batch_shape, n = xr.shape[:-1], xr.shape[-1]
    if n == 1:  # W^{row * 0} = 1: the global twiddle is the identity too
        return xr, xi
    fft_plan.log2i(n)
    xr2 = xr.reshape(-1, n).contiguous()
    xi2 = xi.reshape(-1, n).contiguous()
    p = fft_plan.make_plan(n)
    if p.levels == 1:
        yr, yi = _leaf(xr2, xi2, impl, global_twiddle=global_twiddle)
    elif global_twiddle is not None:
        raise ValueError("global_twiddle requires a single-level plan")
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
             layout: str = "zero_copy", out_major: str = "row",
             global_twiddle: tuple[int, int] | None = None,
             col_offset: int = 0, ncols: int | None = None) -> Planar:
    """FFT each COLUMN of planar (L, C) tensors, or of the column slab
    [col_offset, col_offset + ncols).

    Returns (C', L) row-major for ``out_major="row"`` or (L, C')
    column-major for ``out_major="col"`` (C' = ncols when a slab is
    selected): semantically ``fft(xr.T, xi.T)``, but on the zero-copy path
    the column-strided kernel reads the operand in place and writes the
    requested layout directly. ``global_twiddle`` as in `axis_pass`. A
    thin wrapper over `axis_pass` with a B=1 view.
    """
    L, C = xr.shape
    nc = C - col_offset if ncols is None else ncols
    yr, yi = axis_pass(xr, xi, (1, L, C), out_major=out_major,
                       global_twiddle=global_twiddle, impl=impl,
                       layout=layout, col_offset=col_offset, ncols=nc)
    if out_major == "col":
        return yr.reshape(L, nc), yi.reshape(L, nc)
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
        with span(ROWS):
            yr, yi = fft(x, torch.zeros_like(x), impl=impl, layout=layout)
        return yr[..., : n // 2 + 1], yi[..., : n // 2 + 1]
    fft_plan.log2i(n)
    m = n // 2
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, n).contiguous()
    if fft_plan.make_plan(m).levels == 1:
        with span(ROWS):
            yr, yi = rfft_leaf(x2)
    else:
        # bin k pairs with bin m - k, which a level-1 pass puts in another
        # leaf, so the untangle runs after the whole half-length transform
        z = x2.reshape(-1, m, 2)
        with span(ROWS):
            zr, zi = fft(z[..., 0], z[..., 1], impl=impl, layout=layout)
        with span(UNTANGLE):
            yr, yi = untangle_half_spectrum(zr, zi,
                                            *rfft_twiddle(n, x.device))
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
        with span(ROWS):
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
    with span(ROWS):
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


# ---------------------------------------------------------------------------
# N-D transforms: axis passes, no outer twiddle (the DFT is separable)


def _flip_leading(pr, pi, ndim: int, nd: int) -> Planar:
    """Index-negate (k -> (-k) mod n) every transformed axis but the last."""
    for ax in range(ndim - nd, ndim - 1):
        pr = torch.roll(torch.flip(pr, (ax,)), 1, ax)
        pi = torch.roll(torch.flip(pi, (ax,)), 1, ax)
    return pr, pi


def _untangle_nd(zr, zi, vr, vi, nd: int) -> Planar:
    """N-D untangle of the packed half spectrum AFTER the leading axes'
    DFTs have run on it.

    Same E/O algebra as `untangle_half_spectrum`, but conjugation is
    antilinear — it anticommutes with the leading-axis DFTs — so the
    Hermitian partner of bin (k0, .., k) sits at ((-k0) % n0, ..,
    (m-k) % m): flipped along EVERY transformed axis, not just the last.
    The Nyquist column m is no longer real for nd > 1 (only the full N-D
    Hermitian symmetry survives, not per-column realness).
    """
    with span(UNTANGLE):
        pr, pi = _flip_leading(zr, zi, zr.dim(), nd)
        pr = torch.roll(torch.flip(pr, (-1,)), 1, -1)
        pi = torch.roll(torch.flip(pi, (-1,)), 1, -1)
        er, ei = 0.5 * (zr + pr), 0.5 * (zi - pi)
        our, oui = 0.5 * (zi + pi), 0.5 * (pr - zr)
        xr = er + vr * our - vi * oui
        xi = ei + vr * oui + vi * our
        nyq_r = er[..., :1] - our[..., :1]
        nyq_i = ei[..., :1] - oui[..., :1]
        return (torch.cat([xr, nyq_r], dim=-1),
                torch.cat([xi, nyq_i], dim=-1))


def _entangle_nd(yr, yi, n_last: int, nd: int) -> Planar:
    """Inverse of `_untangle_nd`: one-sided (..., m+1) bins -> the packed
    (..., m) half spectrum, m = n_last/2. irfft's algebra with the
    Hermitian partner flipped along every transformed axis:
    conj(X[(-k0) % n0, .., m-k])."""
    m = n_last // 2
    xr_, xi_ = yr[..., :m], yi[..., :m]
    pr = torch.flip(yr[..., 1:], (-1,))  # conj partner, last axis
    pi = -torch.flip(yi[..., 1:], (-1,))
    pr, pi = _flip_leading(pr, pi, pr.dim(), nd)
    er, ei = 0.5 * (xr_ + pr), 0.5 * (xi_ + pi)
    dr, di = 0.5 * (xr_ - pr), 0.5 * (xi_ - pi)
    vr, vi = rfft_twiddle(n_last, yr.device)
    our = vr * dr + vi * di  # conj(v) * D
    oui = vr * di - vi * dr
    return er - oui, ei + our


def _leading_views(shape: tuple, width: tuple, rows: int):
    """(B, L, C) view of each earlier axis k of ``shape``, last first, over
    a buffer whose trailing dims are ``width`` (``shape`` with the last
    axis as stored)."""
    for k in range(len(shape) - 2, -1, -1):
        yield (rows * math.prod(shape[:k]), shape[k],
               math.prod(width[k + 1:]))


def fftn(xr: torch.Tensor, xi: torch.Tensor, shape, *, impl: str = "matfft",
         layout: str = "zero_copy") -> Planar:
    """N-D forward FFT over the trailing ``len(shape)`` axes.

    The contiguous (last) axis runs the batched 1-D path (level 0/1/2);
    every earlier axis is one `axis_pass` with a column-major store, so on
    the zero-copy path the data never leaves its natural layout (K2 reads
    and writes it in place). layout="copy" materializes a transpose round
    trip per earlier axis: the naive baseline.
    """
    shape = tuple(int(d) for d in shape)
    nd = len(shape)
    if tuple(xr.shape[-nd:]) != shape:
        raise ValueError(
            f"operand trailing dims {tuple(xr.shape[-nd:])} do not match "
            f"transform shape {shape}")
    with span(ROWS):
        yr, yi = fft(xr, xi, impl=impl, layout=layout)
    if nd == 1:
        return yr, yi
    batch = xr.shape[:-nd]
    rows = math.prod(batch)
    for view in _leading_views(shape, shape, rows):
        with span(AXIS_PASS):
            yr, yi = axis_pass(yr, yi, view, out_major="col", impl=impl,
                               layout=layout)
    return yr.reshape(*batch, *shape), yi.reshape(*batch, *shape)


def ifftn(xr: torch.Tensor, xi: torch.Tensor, shape, **kw) -> Planar:
    """Inverse N-D FFT via the global conjugation identity (/prod(shape))."""
    n_total = math.prod(int(d) for d in shape)
    yr, yi = fftn(xr, -xi, shape, **kw)
    return yr / n_total, -yi / n_total


def rfftn(x: torch.Tensor, shape, *, impl: str = "matfft",
          layout: str = "zero_copy") -> Planar:
    """N-D real-input FFT; one-sided over the contiguous axis.

    Returns planar ``(*batch, *shape[:-1], shape[-1]//2 + 1)``, the
    numpy.fft.rfftn/rfft2 convention (r2c on the last axis).

    Fast path (impl="matfft", shape[-1] >= 4): the contiguous axis packs
    n reals as n/2 complex and transforms at half length WITHOUT the
    untangle (K3's `rfft_pack_leaf` reads the real rows as float2 pairs);
    the remaining axes transform the half-width spectrum (the untangle is
    a linear map on the last axis, so it commutes with the other axes'
    DFTs); ONE untangle at the end widens m -> m+1 bins. Otherwise the
    full complex N-D transform, sliced.
    """
    shape = tuple(int(d) for d in shape)
    nd = len(shape)
    x = x.to(torch.float32)
    if nd == 1:
        return rfft(x, impl=impl, layout=layout)
    n_last = shape[-1]
    if n_last < 4 or impl != "matfft":
        yr, yi = fftn(x, torch.zeros_like(x), shape, impl=impl,
                      layout=layout)
        return yr[..., : n_last // 2 + 1], yi[..., : n_last // 2 + 1]
    fft_plan.log2i(n_last)
    m = n_last // 2
    batch = x.shape[:-nd]
    rows = math.prod(batch)
    half = (*shape[:-1], m)

    # the contiguous axis: packed half-length transform, raw half spectrum
    # out; K3 reads float2 pairs, so its rows come from a contiguous buffer
    x2 = x.contiguous().reshape(rows * math.prod(shape[:-1]), n_last)
    with span(ROWS):
        zr, zi = rfft_pack_pass(x2, n_last, impl=impl, layout=layout)

    # the remaining axes on the half-width spectrum (all powers of two)
    for view in _leading_views(shape, half, rows):
        with span(AXIS_PASS):
            zr, zi = axis_pass(zr, zi, view, out_major="col", impl=impl,
                               layout=layout)
    zr = zr.reshape(*batch, *half)
    zi = zi.reshape(*batch, *half)

    # one N-D untangle: m -> m + 1 bins
    vr, vi = rfft_twiddle(n_last, x.device)
    return _untangle_nd(zr, zi, vr, vi, nd)


def irfftn(yr: torch.Tensor, yi: torch.Tensor, shape, *,
           impl: str = "matfft", layout: str = "zero_copy") -> torch.Tensor:
    """Inverse of rfftn: one-sided spectrum -> real ``(*batch, *shape)``.

    Runs the forward factorization in reverse: re-entangle the one-sided
    bins into the half-length spectrum (a power-of-two width again),
    inverse transform the leading axes, then the half-length inverse and
    interleave on the contiguous axis.
    """
    shape = tuple(int(d) for d in shape)
    nd = len(shape)
    if nd == 1:
        return irfft(yr, yi, impl=impl, layout=layout)
    n_last = shape[-1]
    m = n_last // 2
    if m < 2 or impl != "matfft":
        # inverse the leading axes as c2c over materialized transposes,
        # then the 1-D irfft on the contiguous axis
        for k in range(nd - 1):
            ax = k - nd  # negative axis index of shape[k] in the operand
            ar = yr.transpose(ax, -1)
            ai = yi.transpose(ax, -1)
            with span(AXIS_PASS):
                ar, ai = ifft(ar, ai, impl=impl, layout=layout)
            yr = ar.transpose(ax, -1)
            yi = ai.transpose(ax, -1)
        return irfft(yr, yi, impl=impl, layout=layout)
    batch = yr.shape[:-nd]
    rows = math.prod(batch)
    half = (*shape[:-1], m)

    # re-entangle one-sided bins -> half-length spectrum
    zr, zi = _entangle_nd(yr, yi, n_last, nd)

    # leading-axis inverses on the half width (conjugation identity)
    for (b, L, inner) in _leading_views(shape, half, rows):
        with span(AXIS_PASS):
            ar, ai = axis_pass(zr, -zi, (b, L, inner), out_major="col",
                               impl=impl, layout=layout)
        zr = ar.reshape(*batch, *half) / L
        zi = -ai.reshape(*batch, *half) / L

    # contiguous axis: half-length inverse + interleave
    with span(ROWS):
        wr, wi = ifft(zr, zi, impl=impl, layout=layout)
    return torch.stack([wr, wi], dim=-1).reshape(*wr.shape[:-1], n_last)
