"""Matrix-DFT leaf transforms: the Hopper kernels K1, K2 and K3 and their
plain PyTorch versions.

  * ``matfft``       K1, row-major batch: (rows, n) in, (rows, n) out.
  * ``matfft_cols``  K2, column-strided batch: transforms the MIDDLE axis of
    a (B, L, C) view and writes row-major (B*C, L) or column-major
    (B, L, C). Chaining two of these is the zero-copy level-1 four-step:
    no transposed tensor is ever written to device memory.
  * ``rfft_leaf`` / ``rfft_pack_leaf``  K3, real rows: (rows, n) real in,
    the one-sided (rows, n/2 + 1) spectrum or the packed (rows, n/2) half
    spectrum out.

The kernels live in ``csrc/matfft.cu`` (CUDA C++ for ``sm_90a``, built by
`repro_torch.kernels.build` and called through ctypes). They replace the
Pallas kernels of the JAX package's ``kernels/fft/matfft.py``:
``matfft`` (bodies ``_dft_kernel`` and ``_matfft_kernel``),
``matfft_cols`` (body ``_col_kernel``) and ``_rfft_pallas`` (body
``_rfft_kernel``). All run one tile algebra, a radix FFT at every leaf
length, where the reference multiplies by DFT matrices (a direct DFT up
to 256 points, a four-step of matrix products above): n = a * b with
a = min(n, RADIX), radix-2 Stockham stages of length a, the inner twiddle
W_n^{i2*o1}, the b-point DFT by the same rule, output in o2*a + o1 order,
every twiddle an entry of the (n,) table `plan.radix_twiddles`. Up to
RADIX**2 = 256 points that is two passes of at most RADIX points, from
512 to MAX_LEAF = 4096 three. The optional epilogue multiplies each
output row by a row of a periodic table before the store; the level-1
four-step fuses its outer twiddle there. The global-twiddle epilogue
multiplies output row r, column o by W_{n_global}^m, m = ((row_off + r) *
o) mod n_global, read from the two tables of `plan.global_twiddles`: the
distributed four-step fuses its twiddle there. K2 may transform one
aligned slab of its columns, read in place (``col_offset``, ``ncols``).
K3 packs the real row as
m = n/2 complex points on the load, runs the tile algebra at m and
untangles the half spectrum (`untangle_half_spectrum`) in its store.

What bounds them on an H100, and what the design does about it, is set out
at the top of ``csrc/matfft.cu``: about 5 log2 n flops a point against 16
bytes of traffic, so they are bound by bytes. Each pass runs in its
threads' registers, in IEEE f32 on the CUDA cores (no TF32, no tensor
cores), and each kernel touches device memory once per point each way.
K2, and K1 and K3 up to 256 points (K3: its half length m), transform a
tile staged in shared memory; K1 and K3 from 512 points stage none: the
first pass loads from device memory into registers, and only the
intermediates between passes go through shared memory. K1's last pass,
and K3's without the untangle, stores from registers to device memory;
K3's with it writes each row's half spectrum to shared memory once and
untangles a pair of bins k, m-k a thread from there.

A block stages one fixed tile of MAX_LEAF points (K2: at most the
slab's columns): a block keeps 256 threads whatever it stages, so a
narrower tile only leaves threads idle.

Each wrapper takes float32 tensors (planar for K1 and K2, real for K3). On
a CUDA tensor it launches its kernel (and counts the launch in
``<wrapper>.launches``, and its shape in ``launch_shapes``) or raises;
on a CPU tensor it runs the plain version — ``matfft_plain``,
``matfft_cols_plain``, ``rfft_leaf_plain``, ``rfft_pack_leaf_plain`` —
which repeats the tile algebra with PyTorch operations (and counts the
call in ``<plain>.calls``, and its shape in ``plain_shapes``).
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fft import plan as fft_plan

# the leaf runs passes of at most RADIX points in each thread's registers
RADIX = 16

Planar = tuple[torch.Tensor, torch.Tensor]

# (wrapper, operand shape, out_major or None) of each kernel launch, and of
# each call a wrapper gave to its plain version, since `reset_counts`; a
# call with the global twiddle, a column slab or (K2) a thread-block
# cluster adds a fourth entry, its options: ("twiddle",), ("slab",
# ncols), ("cluster", blocks a cluster) or several
launch_shapes: Counter = Counter()
plain_shapes: Counter = Counter()

_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()


def _device_table(key, make, device: torch.device) -> tuple:
    """Cached device copies of host float32 tables, keyed by ``key``."""
    full = (key, str(device))
    with _TABLES_LOCK:
        got = _TABLES.get(full)
        if got is None:
            got = tuple(torch.from_numpy(a).to(device) for a in make())
            if device.type == "cuda":
                # the copies were queued on this thread's stream; kernels
                # on other streams may read them next
                torch.cuda.current_stream(device).synchronize()
            _TABLES[full] = got
        return got


def leaf_tables(n: int, device: torch.device) -> Planar:
    """The leaf transform's table on ``device``: the (n,) roots of unity
    (W_r, W_i) of `plan.radix_twiddles`."""
    if fft_plan.make_plan(n).levels != 1:
        raise ValueError(f"n={n} exceeds one leaf (MAX_LEAF="
                         f"{fft_plan.MAX_LEAF}); use the level-1 four-step")
    return _device_table(("radix", n),
                         lambda: fft_plan.radix_twiddles(n), device)


def outer_twiddle(n1: int, n2: int, device: torch.device) -> Planar:
    """The level-1 four-step's outer twiddle T^T[i2, o1] = W_N^{o1*i2},
    (n2, n1), on ``device``: the epilogue table of its first pass."""
    n = n1 * n2
    return _device_table(
        ("outer", n1, n2),
        lambda: tuple(a.T.copy() for a in fft_plan.twiddle_table(n1, n2, n)),
        device)


def global_twiddle_tables(n_global: int, device: torch.device) -> tuple:
    """The global twiddle's tables on ``device``: (hi_r, hi_i, lo_r,
    lo_i) of `plan.global_twiddles`."""
    return _device_table(("global", n_global),
                         lambda: fft_plan.global_twiddles(n_global)[1:],
                         device)


def rfft_twiddle(n: int, device: torch.device) -> Planar:
    """The real-input transform's packing twiddle v[k] = W_n^k, planar
    (n/2,), on ``device``: the untangle's table."""
    return _device_table(
        ("rfft", n),
        lambda: tuple(a.reshape(-1) for a in fft_plan.rfft_twiddle(n)),
        device)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the on-card yardstick)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def stockham_stages(xr, xi, twiddles) -> Planar:
    """Radix-2 Stockham (decimation in frequency) stages along the last
    axis of (rows, m) planes, natural order in and out. ``twiddles``
    gives, stage by stage (l = m/2, m/4, ..., 1), the planar (l,) stage
    twiddles w_j = W_{2l}^j. The plain version of K4 and of the radix
    leaf; the kernels run the same butterflies, rounded the same way."""
    rows, m = xr.shape
    ms = 1
    for wr, wi in twiddles:
        l = m // (2 * ms)
        # x viewed as [r, h, j, k] with flat index h*l*ms + j*ms + k
        xr4 = xr.reshape(rows, 2, l, ms)
        xi4 = xi.reshape(rows, 2, l, ms)
        ar, ai = xr4[:, 0], xi4[:, 0]
        br, bi = xr4[:, 1], xi4[:, 1]
        wr, wi = wr.reshape(1, l, 1), wi.reshape(1, l, 1)
        # y[r, j, 0, k] = a + b, y[r, j, 1, k] = (a - b) * w_j at flat
        # index j*2ms + t*ms + k
        dr, di = ar - br, ai - bi
        tr = wr * dr - wi * di
        ti = wr * di + wi * dr
        xr = torch.stack([ar + br, tr], dim=2).reshape(rows, m)
        xi = torch.stack([ai + bi, ti], dim=2).reshape(rows, m)
        ms *= 2
    return xr, xi


def apply_global_twiddle(yr, yi, n_global: int, row_off: int) -> Planar:
    """(rows, L) planes times W_{n_global}^m at row r, column o, m =
    ((row_off + r) * o) mod n_global, with m exact in int64: the table
    product W^{(m >> k) << k} * W^{m & (2^k - 1)} (`plan.global_twiddles`),
    then the output times it, rounded as the kernels' epilogue rounds.
    The plain version of that epilogue, and the distributed four-step's
    unfused twiddle."""
    rows, L = yr.shape
    hr, hi, lr, li = global_twiddle_tables(n_global, yr.device)
    k = (fft_plan.log2i(n_global) + 1) // 2
    r = torch.arange(row_off, row_off + rows, device=yr.device)
    m = (r[:, None] * torch.arange(L, device=yr.device)) & (n_global - 1)
    h, low = m >> k, m & ((1 << k) - 1)
    tr, ti = _cmul(hr[h], hi[h], lr[low], li[low])
    return _cmul(yr, yi, tr, ti)


def _radix_stages(xr, xi, twr, twi, n: int) -> Planar:
    """An m-point DFT of (rows, m) planes by Stockham stages whose twiddle
    W_{2l}^j is entry j*n/(2l) of the length-n table: the kernel's
    `reg_dft`."""
    def twiddles():
        l = xr.shape[1] // 2
        while l >= 1:
            step = n // (2 * l)
            yield twr[:l * step:step], twi[:l * step:step]
            l //= 2

    return stockham_stages(xr, xi, twiddles())


def _radix_plain(xr, xi, tables) -> Planar:
    """The m-point DFT of (rows, m) planes as the kernel runs it, every
    twiddle an entry of the (n,) leaf table, m dividing n: m = a*b with
    a = min(m, RADIX), a-point stages over i1 for each (row, i2), the inner
    twiddle W_m^{i2*o1} = entry i2*o1*n/m, the b-point DFT over i2 for each
    (row, o1) by the same rule, output at o2*a + o1. At m = n that is the
    kernel's `tile_radix` up to 256 points and `tile_radix3` (K1:
    `rows_radix3`) above."""
    twr, twi = tables
    rows, m = xr.shape
    n = twr.shape[0]
    a = min(m, RADIX)
    b = m // a
    if b == 1:
        return _radix_stages(xr, xi, twr, twi, n)

    def by_column(x):  # x[r, i1*b + i2] -> rows (r, i2), cols i1
        return x.reshape(rows, a, b).transpose(1, 2).reshape(rows * b, a)

    ar, ai = _radix_stages(by_column(xr), by_column(xi), twr, twi, n)
    k = (torch.arange(b, device=xr.device)[:, None]
         * torch.arange(a, device=xr.device)).reshape(-1) * (n // m)
    ar, ai = _cmul(ar.reshape(rows, b * a), ai.reshape(rows, b * a),
                   twr[k], twi[k])

    def by_row(x):  # x[r, i2*a + o1] -> rows (r, o1), cols i2
        return x.reshape(rows, b, a).transpose(1, 2).reshape(rows * a, b)

    cr, ci = _radix_plain(by_row(ar), by_row(ai), tables)

    def out_order(x):  # rows (r, o1), cols o2 -> flat o = o2*a + o1
        return x.reshape(rows, a, b).transpose(1, 2).reshape(rows, m)

    return out_order(cr), out_order(ci)


def matfft_plain(xr: torch.Tensor, xi: torch.Tensor, *,
                 epilogue: Planar | None = None,
                 global_twiddle: tuple[int, int] | None = None) -> Planar:
    """Plain PyTorch version of `matfft`, same arguments and algebra. It
    transforms every row at once."""
    matfft_plain.calls += 1
    rows, n = _check_rows(xr, xi, epilogue)
    gt = _check_global_twiddle(global_twiddle, epilogue)
    yr, yi = _radix_plain(xr, xi, leaf_tables(n, xr.device))
    if epilogue is not None:
        er, ei = epilogue
        idx = torch.arange(rows, device=xr.device) % er.shape[0]
        yr, yi = _cmul(yr, yi, er[idx], ei[idx])
    elif gt is not None:
        yr, yi = apply_global_twiddle(yr, yi, *gt)
    return yr, yi


matfft_plain.calls = 0


def matfft_cols_plain(xr: torch.Tensor, xi: torch.Tensor, *,
                      out_major: str = "row",
                      epilogue: Planar | None = None,
                      global_twiddle: tuple[int, int] | None = None,
                      col_offset: int = 0,
                      ncols: int | None = None) -> Planar:
    """Plain PyTorch version of `matfft_cols`, same arguments and algebra
    (the slab and the transposes are materialized here; the kernel makes
    none)."""
    matfft_cols_plain.calls += 1
    B, L, C, nc = _check_cols(xr, xi, out_major, epilogue, col_offset,
                              ncols)
    gt = _check_global_twiddle(global_twiddle, epilogue)
    cols = slice(col_offset, col_offset + nc)
    xrt = xr[:, :, cols].transpose(1, 2).reshape(B * nc, L)
    xit = xi[:, :, cols].transpose(1, 2).reshape(B * nc, L)
    yr, yi = _radix_plain(xrt, xit, leaf_tables(L, xr.device))
    if epilogue is not None:
        er, ei = epilogue
        yr, yi = _cmul(yr, yi, er[cols].repeat(B, 1), ei[cols].repeat(B, 1))
    elif gt is not None:
        yr, yi = apply_global_twiddle(yr, yi, *gt)
    if out_major == "col":
        yr = yr.reshape(B, nc, L).transpose(1, 2).contiguous()
        yi = yi.reshape(B, nc, L).transpose(1, 2).contiguous()
    return yr, yi


matfft_cols_plain.calls = 0


def untangle_half_spectrum(yr, yi, vr, vi) -> Planar:
    """One-sided real-input spectrum from the half-length packed transform.

    Given Y = DFT_m(x[..., 0::2] + 1j*x[..., 1::2]) along the last axis,
    the even/odd sub-spectra are recovered from the conjugate-symmetric
    partner Y[(m-k) % m] and combined with the packing twiddle
    v[k] = W_{2m}^k:

        E[k] = (Y[k] + conj(Y[m-k]))/2      O[k] = (Y[k] - conj(Y[m-k]))/2i
        X[k] = E[k] + v[k]*O[k]   k < m;    X[m] = E[0] - O[0]  (Nyquist)

    Torch ops on (..., m) planes -> (..., m+1), in the JAX package's
    expression order; K3 rounds its fused untangle the same way. Also the
    untangle of the level-1 rfft path (`executors.rfft`).
    """
    # conj partner p[k] = Y[(m-k) % m]: reverse then rotate right by one
    pr = torch.roll(torch.flip(yr, (-1,)), 1, -1)
    pi = torch.roll(torch.flip(yi, (-1,)), 1, -1)
    er, ei = 0.5 * (yr + pr), 0.5 * (yi - pi)
    our, oui = 0.5 * (yi + pi), 0.5 * (pr - yr)
    xr = er + vr * our - vi * oui
    xi = ei + vr * oui + vi * our
    nyq = er[..., :1] - our[..., :1]
    return (torch.cat([xr, nyq], dim=-1),
            torch.cat([xi, torch.zeros_like(nyq)], dim=-1))


def _rfft_plain(x: torch.Tensor, untangle: bool, what: str) -> Planar:
    """Pack, half-length tile DFT, optional untangle: K3's algebra."""
    _, n, m = _check_real(x, what)
    yr, yi = _radix_plain(x[:, 0::2], x[:, 1::2], leaf_tables(m, x.device))
    if not untangle:
        return yr, yi
    return untangle_half_spectrum(yr, yi, *rfft_twiddle(n, x.device))


def rfft_leaf_plain(x: torch.Tensor) -> Planar:
    """Plain PyTorch version of `rfft_leaf`, same argument and algebra."""
    rfft_leaf_plain.calls += 1
    return _rfft_plain(x, True, "rfft_leaf")


rfft_leaf_plain.calls = 0


def rfft_pack_leaf_plain(x: torch.Tensor) -> Planar:
    """Plain PyTorch version of `rfft_pack_leaf`."""
    rfft_pack_leaf_plain.calls += 1
    return _rfft_plain(x, False, "rfft_pack_leaf")


rfft_pack_leaf_plain.calls = 0


# ---------------------------------------------------------------------------
# argument checks shared by the kernels and their plain versions


def _check_planes(xr, xi, ndim: int, what: str) -> None:
    if xr.shape != xi.shape or xr.dim() != ndim:
        raise ValueError(f"{what} expects two {ndim}-D planes of one shape, "
                         f"got {tuple(xr.shape)} and {tuple(xi.shape)}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 planes, got {xr.dtype}")
    if xr.device != xi.device:
        raise ValueError(f"{what}: planes on {xr.device} and {xi.device}")


def _check_epilogue(epilogue, shape: tuple, device, what: str) -> None:
    er, ei = epilogue
    if tuple(er.shape) != shape or tuple(ei.shape) != shape:
        raise ValueError(f"{what}: epilogue must be {shape}, "
                         f"got {tuple(er.shape)}")
    if er.dtype != torch.float32 or ei.dtype != torch.float32:
        raise TypeError(f"{what}: epilogue must be float32, got {er.dtype}")
    if er.device != device or ei.device != device:
        raise ValueError(f"{what}: epilogue on {er.device}, operand on "
                         f"{device}")


def _check_rows(xr, xi, epilogue) -> tuple[int, int]:
    _check_planes(xr, xi, 2, "matfft")
    rows, n = xr.shape
    if fft_plan.make_plan(n).levels != 1:
        raise ValueError(f"n={n} exceeds single-kernel capacity "
                         f"(MAX_LEAF={fft_plan.MAX_LEAF})")
    if epilogue is not None:
        period = epilogue[0].shape[0]
        if not fft_plan.is_pow2(period):
            raise ValueError("epilogue period must be a power of two")
        _check_epilogue(epilogue, (period, n), xr.device, "matfft")
    return rows, n


def _check_cols(xr, xi, out_major, epilogue, col_offset: int = 0,
               ncols: int | None = None) -> tuple[int, int, int, int]:
    """(B, L, C, ncols) of a K2 call on the slab [col_offset, col_offset +
    ncols) of (B, L, C) planes: a power of two, aligned to its width."""
    _check_planes(xr, xi, 3, "matfft_cols")
    B, L, C = xr.shape
    if fft_plan.make_plan(L).levels != 1:
        raise ValueError(f"L={L} exceeds single-kernel capacity")
    if not fft_plan.is_pow2(C):
        raise ValueError(f"column count must be a power of two, got {C}")
    if out_major not in ("row", "col"):
        raise ValueError(f"unknown out_major {out_major!r}")
    nc = C - col_offset if ncols is None else ncols
    if not fft_plan.is_pow2(nc):
        raise ValueError(f"ncols must be a power of two, got {nc}")
    if col_offset % nc or col_offset + nc > C:
        raise ValueError(
            f"column slab [{col_offset}, {col_offset + nc}) must be an "
            f"aligned pow2 slab of the {C} columns")
    if epilogue is not None:
        _check_epilogue(epilogue, (C, L), xr.device, "matfft_cols")
    return B, L, C, nc


def _check_global_twiddle(global_twiddle, epilogue) -> tuple | None:
    """(n_global, row_off) of the global-twiddle option: n_global a power
    of two up to 2^32 (the kernels reduce the exponent in 32-bit unsigned
    arithmetic), row_off a host int >= 0; never with a table epilogue."""
    if global_twiddle is None:
        return None
    if epilogue is not None:
        raise ValueError("epilogue and global_twiddle are mutually "
                         "exclusive")
    n_global, row_off = (int(v) for v in global_twiddle)
    fft_plan.log2i(n_global)
    if n_global > 1 << 32 or row_off < 0:
        raise ValueError(f"global_twiddle needs n_global <= 2^32 and "
                         f"row_off >= 0, got {global_twiddle}")
    return n_global, row_off


def _check_real(x, what: str) -> tuple[int, int, int]:
    """(rows, n, m = n/2) of real rows K3 takes: n a power of two >= 4
    whose half m is one leaf, as the JAX package's `_rfft_pallas`."""
    if x.dim() != 2:
        raise ValueError(f"{what} expects 2-D (rows, n), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 rows, got {x.dtype}")
    rows, n = x.shape
    fft_plan.log2i(n)
    if n < 4:
        raise ValueError(f"{what} needs n >= 4, got {n}")
    m = n // 2
    if fft_plan.make_plan(m).levels != 1:
        raise ValueError(f"n={n} exceeds {what} capacity (n/2 <= MAX_LEAF="
                         f"{fft_plan.MAX_LEAF}); use executors.rfft")
    return rows, n, m


# ---------------------------------------------------------------------------
# the kernels' wrappers

_c_ptr, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BOUND = threading.Event()


def _lib() -> ctypes.CDLL:
    lib = build.load("matfft")
    if not _BOUND.is_set():
        # ... the global twiddle's four tables, n_global, row_off, stream
        gtw = [_c_ptr] * 4 + [_c_ll, _c_ll, _c_ptr]
        lib.matfft_rows.argtypes = [_c_ptr] * 4 + [_c_ll, _c_int] + \
            [_c_ptr] * 4 + [_c_int] + gtw
        lib.matfft_rows.restype = _c_int
        # ... the cluster's blocks, stream
        lib.matfft_cols.argtypes = [_c_ptr] * 4 + [_c_ll] + [_c_int] * 4 + \
            [_c_ptr] * 4 + [_c_int] + gtw[:-1] + [_c_int, _c_ptr]
        lib.matfft_cols.restype = _c_int
        lib.matfft_cols_clusters.argtypes = [_c_int] * 2
        lib.matfft_cols_clusters.restype = _c_int
        lib.matfft_rfft.argtypes = [_c_ptr] * 3 + [_c_ll, _c_int] + \
            [_c_ptr] * 4 + [_c_int, _c_ptr]
        lib.matfft_rfft.restype = _c_int
        _BOUND.set()
    return lib


def _check_cuda(xr, what: str) -> None:
    if xr.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{xr.device}")


def _contiguous(*ts, what: str) -> None:
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")


def _global_twiddle_args(gt, device) -> list:
    """The kernels' global-twiddle arguments: its tables' pointers,
    n_global and row_off (null pointers and zeros without it)."""
    if gt is None:
        return [None] * 4 + [0, 0]
    return [t.data_ptr() for t in global_twiddle_tables(gt[0], device)] + \
        list(gt)


def _launch_key(wrapper: str, shape, major, gt=None, ncols=None,
                cluster: int = 1) -> tuple:
    """The `launch_shapes` key of a call; with the global twiddle, a
    column slab or a cluster of K > 1 blocks, a fourth entry:
    ("twiddle",), ("slab", ncols), ("cluster", K) or several."""
    opts = (("twiddle",) if gt is not None else ()) + (
        ("slab", ncols) if ncols is not None else ()) + (
        ("cluster", cluster) if cluster > 1 else ())
    return (wrapper, tuple(shape), major) + ((opts,) if opts else ())


def matfft(xr: torch.Tensor, xi: torch.Tensor, *,
           epilogue: Planar | None = None,
           global_twiddle: tuple[int, int] | None = None) -> Planar:
    """Batched forward DFT along the last axis of planar (rows, n) float32
    tensors, n a power of two <= MAX_LEAF.

    epilogue: optional planar (period, n) table, period a power of two;
      output row r is multiplied by ``epilogue[r % period]``.
    global_twiddle: optional (n_global, row_off), host ints: output row r,
      column o is multiplied by W_{n_global}^{(row_off + r) * o}, the
      distributed four-step's twiddle (n_global a power of two <= 2^32).
    """
    gt = _check_global_twiddle(global_twiddle, epilogue)
    key = _launch_key("matfft", xr.shape, None, gt)
    if xr.device.type == "cpu":
        plain_shapes[key] += 1
        return matfft_plain(xr, xi, epilogue=epilogue, global_twiddle=gt)
    _check_cuda(xr, "matfft")
    rows, n = _check_rows(xr, xi, epilogue)
    er, ei = epilogue if epilogue is not None else (None, None)
    _contiguous(xr, xi, er, ei, what="matfft")
    wr, wi = leaf_tables(n, xr.device)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    rc = _lib().matfft_rows(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows, n,
        wr.data_ptr(), wi.data_ptr(),
        er.data_ptr() if er is not None else None,
        ei.data_ptr() if ei is not None else None,
        er.shape[0] if er is not None else 1,
        *_global_twiddle_args(gt, xr.device),
        torch.cuda.current_stream(xr.device).cuda_stream)
    if rc:
        raise RuntimeError(f"matfft kernel launch failed: CUDA error {rc}")
    matfft.launches += 1
    launch_shapes[key] += 1
    return yr, yi


matfft.launches = 0


def matfft_cols(xr: torch.Tensor, xi: torch.Tensor, *,
                out_major: str = "row", epilogue: Planar | None = None,
                global_twiddle: tuple[int, int] | None = None,
                col_offset: int = 0, ncols: int | None = None) -> Planar:
    """Batched forward DFT along the MIDDLE axis of planar (B, L, C) float32
    tensors; L a power of two <= MAX_LEAF, C a power of two.

    Logical batch row r = b*nc + c transforms the column x[b, :,
    col_offset + c] of the slab of nc = ``ncols`` columns (default all
    from ``col_offset`` on: a power of two, ``col_offset`` a multiple of
    it), read in place from the full operand.
    out_major: "row" returns (B*nc, L) with row b*nc + c; "col" returns
      (B, L, nc) with out[b, o, c] — the transformed axis stays in place.
    epilogue: optional planar (C, L) table; output row (b, c) is
      multiplied by ``epilogue[col_offset + c]``.
    global_twiddle: optional (n_global, row_off), host ints: output row
      (b, c), column o is multiplied by W_{n_global}^{(row_off + b*nc + c)
      * o}, the distributed four-step's twiddle.

    A block transforms min(MAX_LEAF // L, nc) columns. A launch whose
    block holds fewer than `plan.CLUSTER_COLS` columns of a slab of at
    least that many (L >= 1024), with both
    planes on 16 bytes, runs as thread-block clusters
    (`plan.col_cluster`), the same bits again; the key in `launch_shapes`
    records the cluster's blocks. A cluster launch the card refuses
    raises, as any refused launch does.
    """
    gt = _check_global_twiddle(global_twiddle, epilogue)
    sliced = col_offset != 0 or ncols not in (None, xr.shape[-1])
    nc = (xr.shape[-1] - col_offset) if ncols is None else ncols
    _, K = fft_plan.col_cluster(
        xr.shape[-2], max(nc, 1),
        aligned=not (xr.data_ptr() | xi.data_ptr()) % 16)
    key = _launch_key("matfft_cols", xr.shape, out_major, gt,
                      ncols if sliced else None, K)
    if xr.device.type == "cpu":
        plain_shapes[key] += 1
        return matfft_cols_plain(xr, xi, out_major=out_major,
                                 epilogue=epilogue, global_twiddle=gt,
                                 col_offset=col_offset, ncols=ncols)
    _check_cuda(xr, "matfft_cols")
    B, L, C, nc = _check_cols(xr, xi, out_major, epilogue, col_offset, ncols)
    er, ei = epilogue if epilogue is not None else (None, None)
    _contiguous(xr, xi, er, ei, what="matfft_cols")
    wr, wi = leaf_tables(L, xr.device)
    shape = (B * nc, L) if out_major == "row" else (B, L, nc)
    yr = torch.empty(shape, dtype=torch.float32, device=xr.device)
    yi = torch.empty(shape, dtype=torch.float32, device=xr.device)
    rc = _lib().matfft_cols(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), B, L, C,
        col_offset, nc, wr.data_ptr(), wi.data_ptr(),
        er.data_ptr() if er is not None else None,
        ei.data_ptr() if ei is not None else None,
        int(out_major == "col"), *_global_twiddle_args(gt, xr.device),
        K, torch.cuda.current_stream(xr.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"matfft_cols kernel launch failed: CUDA error {rc}"
            + (f" (a cluster of {K} blocks)" if K > 1 else ""))
    matfft_cols.launches += 1
    launch_shapes[key] += 1
    return yr, yi


matfft_cols.launches = 0


def cols_clusters_resident(L: int) -> tuple[int, int]:
    """(K, clusters): the blocks of K2's cluster at length L
    (`plan.col_cluster`), and how many such clusters the current card
    holds at once (cudaOccupancyMaxActiveClusters). Needs the card."""
    R, K = fft_plan.col_cluster(L, fft_plan.MAX_LEAF)
    if K == 1:
        raise ValueError(f"K2 at L={L}, {R} columns a block, runs no "
                         f"cluster")
    n = _lib().matfft_cols_clusters(L, K)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error "
                           f"{-n}")
    return K, n


def _launch_rfft(x: torch.Tensor, untangle: bool, what: str) -> Planar:
    _check_cuda(x, what)
    rows, n, m = _check_real(x, what)
    _contiguous(x, what=what)
    if x.data_ptr() % 8:
        raise ValueError(f"{what} reads each row as float2 pairs: the "
                         f"tensor must start 8-byte aligned")
    wr, wi = leaf_tables(m, x.device)
    vr, vi = rfft_twiddle(n, x.device)
    shape = (rows, m + 1 if untangle else m)
    yr = torch.empty(shape, dtype=torch.float32, device=x.device)
    yi = torch.empty(shape, dtype=torch.float32, device=x.device)
    rc = _lib().matfft_rfft(
        x.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows, m, wr.data_ptr(),
        wi.data_ptr(), vr.data_ptr(), vi.data_ptr(), int(untangle),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return yr, yi


def rfft_leaf(x: torch.Tensor) -> Planar:
    """One-sided spectrum of real (rows, n) float32 rows, n a power of two
    >= 4 with n/2 <= MAX_LEAF. Returns planar (rows, n/2 + 1) tensors.

    Costs one HALF-length DFT: the kernel reads the real rows as n/2
    complex points and untangles the half spectrum in its store.
    """
    key = _launch_key("rfft_leaf", x.shape, None)
    if x.device.type == "cpu":
        plain_shapes[key] += 1
        return rfft_leaf_plain(x)
    y = _launch_rfft(x, True, "rfft_leaf")
    rfft_leaf.launches += 1
    launch_shapes[key] += 1
    return y


rfft_leaf.launches = 0


def rfft_pack_leaf(x: torch.Tensor) -> Planar:
    """Raw packed half spectrum of real (rows, n) rows: DFT_m of
    x[:, 0::2] + i*x[:, 1::2], planar (rows, n/2), NO untangle (the N-D
    real-input path untangles after its remaining axes)."""
    key = _launch_key("rfft_pack_leaf", x.shape, None)
    if x.device.type == "cpu":
        plain_shapes[key] += 1
        return rfft_pack_leaf_plain(x)
    y = _launch_rfft(x, False, "rfft_pack_leaf")
    rfft_pack_leaf.launches += 1
    launch_shapes[key] += 1
    return y


rfft_pack_leaf.launches = 0


def reset_counts() -> None:
    """Zero every launch and plain-call counter of this module, and the
    shape counters (`stockham` records its calls there too)."""
    launch_shapes.clear()
    plain_shapes.clear()
    matfft.launches = matfft_cols.launches = 0
    rfft_leaf.launches = rfft_pack_leaf.launches = 0
    matfft_plain.calls = matfft_cols_plain.calls = 0
    rfft_leaf_plain.calls = rfft_pack_leaf_plain.calls = 0
