"""The plain reference: the discrete Fourier transform by its definition.

Every transform here is a product with DFT matrices that this module
builds itself, W[j, k] = exp(-2 pi i (j k mod n) / n), with the index
product reduced exactly in integers before the angle is taken. It uses
plain PyTorch only and nothing of the program: no kernel, plan or table.

Two precisions:

  "float64"  the reference: float64 operands and products.
  "tf32"     the control: the same products with every operand rounded to
             TF32 (a 10-bit mantissa) and float32 matrix products with
             TF32 allowed, the precision a float32 program may not drop to.

`Gap` measures how far a program's output lies from the reference: the
root mean square and the widest gap of one bin, each over the root mean
square of the reference's bins.
"""

from __future__ import annotations

import contextlib
import math

import torch

PRECISIONS = ("float64", "tf32")


def mulmod(j: torch.Tensor, k: torch.Tensor, n: int) -> torch.Tensor:
    """(j * k) mod n for int64 tensors that broadcast, exact for n up to
    2**31, and for powers of two up to 2**46 (products above 2**63 are
    split at 16 bits of k)."""
    j, k = j % n, k % n
    if n <= 1 << 31:
        return (j * k) % n
    if n & (n - 1):
        raise ValueError(f"n={n} above 2**31 must be a power of two")
    lo, hi = k & 0xFFFF, k >> 16
    return (j * lo + ((j * hi) % (n >> 16)) * 65536) % n


def twiddles(m: torch.Tensor, n: int, precision: str):
    """cos and sin of -2 pi m / n for int64 exponents m < n."""
    angle = m.to(torch.float64) * (-2.0 * math.pi / n)
    wr, wi = torch.cos(angle), torch.sin(angle)
    if precision == "float64":
        return wr, wi
    return to_tf32(wr.float()), to_tf32(wi.float())


def dft_matrix(n: int, cols: int | None, device, precision: str):
    """Planar W[j, k], j < n, k < cols (default n)."""
    cols = n if cols is None else cols
    j = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return twiddles(mulmod(j, k, n), n, precision)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _dtype(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.double() if precision == "float64" else to_tf32(x)


def cmatmul(ar, ai, br, bi, precision: str):
    """(ar + i ai) @ (br + i bi) in real products; ``ai`` None for a real
    left operand."""
    ar, br, bi = (_operand(t, precision) for t in (ar, br, bi))
    with _matmul_precision(precision):
        if ai is None:
            return ar @ br, ar @ bi
        ai = _operand(ai, precision)
        return ar @ br - ai @ bi, ar @ bi + ai @ br


def transform(xr, xi, ndim: int, kind: str, precision: str = "float64",
              cache: dict | None = None):
    """The forward DFT over the trailing ``ndim`` axes of planar ``xr``,
    ``xi`` (``xi`` None for kind "r2c", whose last axis keeps its one-sided
    n // 2 + 1 bins). Returns planes in the precision's dtype."""
    cache = {} if cache is None else cache

    def matrix(n, cols):
        key = (n, cols, xr.device, precision)
        if key not in cache:
            cache[key] = dft_matrix(n, cols, xr.device, precision)
        return cache[key]

    n = xr.shape[-1]
    cols = n // 2 + 1 if kind == "r2c" else n
    yr, yi = cmatmul(xr, None if kind == "r2c" else xi, *matrix(n, cols),
                     precision)
    for axis in range(-2, -ndim - 1, -1):
        n = yr.shape[axis]
        ar, ai = (y.movedim(axis, -1) for y in (yr, yi))
        ar, ai = cmatmul(ar, ai, *matrix(n, n), precision)
        yr, yi = (a.movedim(-1, axis) for a in (ar, ai))
    return yr, yi


def transform_rows(xr, xi, ndim: int, kind: str, precision: str = "float64",
                   rows_per_block: int = 1):
    """`transform` over the leading (batch) axis in blocks of
    ``rows_per_block``, so that float64 copies of a large operand fit:
    yields (slice, yr, yi)."""
    cache = {}
    for r0 in range(0, xr.shape[0], rows_per_block):
        sl = slice(r0, r0 + rows_per_block)
        yr, yi = transform(xr[sl], None if xi is None else xi[sl], ndim,
                           kind, precision, cache)
        yield sl, yr, yi


def sampled_bins(xr, xi, offset: int, n: int, bins: torch.Tensor,
                 precision: str = "float64", rows_per_block: int = 1024):
    """Partial sums S[k] = sum_j x[j] W^(j k), k in ``bins``, over one
    contiguous shard x[offset : offset + len(xr)] of a length-n signal.
    The shard is split j = offset + a M + b: a product with the (M, K)
    matrix W^(b k), then the (A, K) outer twiddles W^((offset + a M) k),
    summed over a. The shards' sums add up to the DFT at ``bins``."""
    length = xr.shape[0]
    m = 1 << (int(math.log2(length)) // 2)
    a_rows = length // m
    k = bins.to(torch.int64).to(xr.device)
    b = torch.arange(m, dtype=torch.int64, device=xr.device)[:, None]
    tr, ti = twiddles(mulmod(b, k[None, :], n), n, precision)
    sr = torch.zeros(k.shape[0], dtype=_dtype(precision), device=xr.device)
    si = torch.zeros_like(sr)
    x2r, x2i = xr.reshape(a_rows, m), xi.reshape(a_rows, m)
    for a0 in range(0, a_rows, rows_per_block):
        a1 = min(a0 + rows_per_block, a_rows)
        yr, yi = cmatmul(x2r[a0:a1], x2i[a0:a1], tr, ti, precision)
        j = offset + torch.arange(a0, a1, dtype=torch.int64,
                                  device=xr.device)[:, None] * m
        pr, pi = twiddles(mulmod(j, k[None, :], n), n, precision)
        sr += (pr * yr - pi * yi).sum(0)
        si += (pr * yi + pi * yr).sum(0)
    return sr, si


def probe_in(xr, xi, offset: int, n: int, m: int,
             precision: str = "float64", chunk: int = 1 << 24):
    """One shard's part of sum_k X[k] z^k, z = exp(i pi (2m + 1) / n), from
    the input side: sum_j x[j] R[j] with R[j] = sum_k W^(j k) z^k = 1 + i
    cot(pi (2m + 1 - 2j) / (2n)) in closed form (z^n = -1). Every output
    bin enters the probe with weight 1, so a fault anywhere in the output
    moves it."""
    dtype = _dtype(precision)
    qr = torch.zeros((), dtype=dtype, device=xr.device)
    qi = torch.zeros_like(qr)
    for c0 in range(0, xr.shape[0], chunk):
        j = offset + c0 + torch.arange(min(chunk, xr.shape[0] - c0),
                                       dtype=torch.int64, device=xr.device)
        cot = 1.0 / torch.tan((2 * m + 1 - 2 * j).to(torch.float64)
                              * (math.pi / (2 * n)))
        ar, ai = (_operand(t[c0:c0 + chunk], precision) for t in (xr, xi))
        if precision != "float64":
            cot = to_tf32(cot.float())
        qr += (ar - ai * cot).sum()
        qi += (ai + ar * cot).sum()
    return qr, qi


def probe_out(yr, yi, offset: int, n: int, m: int, chunk: int = 1 << 24):
    """One shard's part of sum_k Y[k] z^k over output bins offset + k, in
    float64, z as in `probe_in`."""
    qr = torch.zeros((), dtype=torch.float64, device=yr.device)
    qi = torch.zeros_like(qr)
    for c0 in range(0, yr.shape[0], chunk):
        k = offset + c0 + torch.arange(min(chunk, yr.shape[0] - c0),
                                       dtype=torch.int64, device=yr.device)
        angle = mulmod(k, torch.tensor(2 * m + 1, device=yr.device),
                       2 * n).to(torch.float64) * (math.pi / n)
        zr, zi = torch.cos(angle), torch.sin(angle)
        ar, ai = (t[c0:c0 + chunk].double() for t in (yr, yi))
        qr += (ar * zr - ai * zi).sum()
        qi += (ar * zi + ai * zr).sum()
    return qr, qi


class Gap:
    """Accumulates the gap between program output planes and reference
    planes, block by block, in float64."""

    def __init__(self):
        self.sse = 0.0       # sum of |y - r|^2
        self.ssr = 0.0       # sum of |r|^2
        self.count = 0       # bins compared
        self.max_abs = 0.0   # widest |y - r|

    def add(self, yr, yi, rr, ri) -> None:
        rr, ri = rr.double(), ri.double()
        d2 = (yr.double() - rr) ** 2 + (yi.double() - ri) ** 2
        self.sse += float(d2.sum())
        self.max_abs = max(self.max_abs, math.sqrt(float(d2.max())))
        self.ssr += float((rr * rr + ri * ri).sum())
        self.count += rr.numel()

    def numbers(self, ref_mean_square: float | None = None) -> dict:
        """rel_rms_err and rel_max_err over the root mean square of the
        reference's bins (``ref_mean_square`` where the bins compared are a
        sample: the mean |X|^2 of every bin, by Parseval)."""
        ms = (self.ssr / self.count if ref_mean_square is None
              else ref_mean_square)
        return {"rel_rms_err": math.sqrt(self.sse / self.count / ms),
                "rel_max_err": self.max_abs / math.sqrt(ms)}
