"""Matrix-DFT leaf transforms: the Hopper kernels K1 and K2 and their plain
PyTorch versions.

  * ``matfft``       K1, row-major batch: (rows, n) in, (rows, n) out.
  * ``matfft_cols``  K2, column-strided batch: transforms the MIDDLE axis of
    a (B, L, C) view and writes row-major (B*C, L) or column-major
    (B, L, C). Chaining two of these is the zero-copy level-1 four-step:
    no transposed tensor is ever written to device memory.

Both kernels live in ``csrc/matfft.cu`` (CUDA C++ for ``sm_90a``, built
by `repro_torch.kernels.build` and called through ctypes). They replace the
Pallas kernels of the JAX package's ``kernels/fft/matfft.py``:
``matfft`` (bodies ``_dft_kernel`` and ``_matfft_kernel``) and
``matfft_cols`` (body ``_col_kernel``). Both run one tile algebra: the
direct DFT, one complex product with the (n, n) DFT matrix, for
n <= DIRECT_N; above it the four-step n = n1 * n2 — column DFTs with
W_{n1}, the inner twiddle T, row DFTs with W_{n2}, output in o2*n1 + o1
order. The optional epilogue multiplies each output row by a row of a
periodic table before the store; the level-1 four-step fuses its outer
twiddle there.

What bounds them on an H100, and what the design does about it, is set out
at the top of ``csrc/matfft.cu``: the matrix formulation issues
4*n*(n1+n2) real FMAs per row against 16*n bytes of traffic, so the
kernels are bound by f32 FMA issue and shared-memory reads; each block
transforms its rows in place in shared memory with IEEE f32 FMAs (no TF32,
no tensor cores) and touches device memory once per point each way.

Each wrapper takes planar float32 tensors. On a CUDA tensor it launches its
kernel (and counts the launch in ``<wrapper>.launches``) or raises; on a
CPU tensor it runs the plain version, ``matfft_plain`` /
``matfft_cols_plain``, which repeats the tile algebra with PyTorch
operations (and counts the call in ``<plain>.calls``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fft import plan as fft_plan

# Transform lengths up to this use one full DFT-matrix product.
DIRECT_N = 256

Planar = tuple[torch.Tensor, torch.Tensor]

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


def leaf_tables(n: int, device: torch.device) -> tuple:
    """The leaf transform's tables on ``device``: (W_r, W_i) for the direct
    DFT, (W1_r, W1_i, Tt_r, Tt_i, W2_r, W2_i) for the four-step, where
    Tt = T^T is the (n2, n1) inner twiddle."""
    p = fft_plan.make_plan(n)
    if p.levels != 1:
        raise ValueError(f"n={n} exceeds one leaf (MAX_LEAF="
                         f"{fft_plan.MAX_LEAF}); use the level-1 four-step")
    if n <= DIRECT_N:
        return _device_table(("direct", n), lambda: fft_plan.dft_matrix(n),
                             device)

    def make():
        w1 = fft_plan.dft_matrix(p.n1)
        tt = tuple(a.T.copy() for a in fft_plan.twiddle_table(p.n1, p.n2, n))
        w2 = fft_plan.dft_matrix(p.n2)
        return (*w1, *tt, *w2)

    return _device_table(("four_step", n), make, device)


def outer_twiddle(n1: int, n2: int, device: torch.device) -> Planar:
    """The level-1 four-step's outer twiddle T^T[i2, o1] = W_N^{o1*i2},
    (n2, n1), on ``device``: the epilogue table of its first pass."""
    n = n1 * n2
    return _device_table(
        ("outer", n1, n2),
        lambda: tuple(a.T.copy() for a in fft_plan.twiddle_table(n1, n2, n)),
        device)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the on-card yardstick)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cgemm(ar, ai, br, bi):
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _tile_dft_plain(xr, xi, tables, n: int) -> Planar:
    """Direct or four-step DFT of (rows, n) planes with the leaf tables."""
    if n <= DIRECT_N:
        wr, wi = tables
        return _cgemm(xr, xi, wr, wi)
    w1r, w1i, tr, ti, w2r, w2i = tables
    n1, n2 = w1r.shape[0], w2r.shape[0]
    rows = xr.shape[0]

    def col_major(x):  # x[b, i1, i2] -> rows (b, i2), cols i1
        return x.reshape(rows, n1, n2).transpose(1, 2).reshape(rows * n2, n1)

    ar, ai = _cgemm(col_major(xr), col_major(xi), w1r, w1i)  # cols o1
    ar, ai = _cmul(ar.reshape(rows, n2, n1), ai.reshape(rows, n2, n1), tr, ti)
    br = ar.transpose(1, 2).reshape(rows * n1, n2)  # rows (b, o1)
    bi = ai.transpose(1, 2).reshape(rows * n1, n2)
    cr, ci = _cgemm(br, bi, w2r, w2i)  # cols o2
    yr = cr.reshape(rows, n1, n2).transpose(1, 2).reshape(rows, n)
    yi = ci.reshape(rows, n1, n2).transpose(1, 2).reshape(rows, n)
    return yr, yi


def matfft_plain(xr: torch.Tensor, xi: torch.Tensor, *,
                 epilogue: Planar | None = None) -> Planar:
    """Plain PyTorch version of `matfft`, same arguments and algebra."""
    matfft_plain.calls += 1
    rows, n = _check_rows(xr, xi, epilogue)
    yr, yi = _tile_dft_plain(xr, xi, leaf_tables(n, xr.device), n)
    if epilogue is not None:
        er, ei = epilogue
        idx = torch.arange(rows, device=xr.device) % er.shape[0]
        yr, yi = _cmul(yr, yi, er[idx], ei[idx])
    return yr, yi


matfft_plain.calls = 0


def matfft_cols_plain(xr: torch.Tensor, xi: torch.Tensor, *,
                      out_major: str = "row",
                      epilogue: Planar | None = None) -> Planar:
    """Plain PyTorch version of `matfft_cols`, same arguments and algebra
    (the transposes are materialized here; the kernel makes none)."""
    matfft_cols_plain.calls += 1
    B, L, C = _check_cols(xr, xi, out_major, epilogue)
    xrt = xr.transpose(1, 2).reshape(B * C, L)
    xit = xi.transpose(1, 2).reshape(B * C, L)
    yr, yi = _tile_dft_plain(xrt, xit, leaf_tables(L, xr.device), L)
    if epilogue is not None:
        er, ei = epilogue
        yr, yi = _cmul(yr, yi, er.repeat(B, 1), ei.repeat(B, 1))
    if out_major == "col":
        yr = yr.reshape(B, C, L).transpose(1, 2).contiguous()
        yi = yi.reshape(B, C, L).transpose(1, 2).contiguous()
    return yr, yi


matfft_cols_plain.calls = 0


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


def _check_cols(xr, xi, out_major, epilogue) -> tuple[int, int, int]:
    _check_planes(xr, xi, 3, "matfft_cols")
    B, L, C = xr.shape
    if fft_plan.make_plan(L).levels != 1:
        raise ValueError(f"L={L} exceeds single-kernel capacity")
    if not fft_plan.is_pow2(C):
        raise ValueError(f"column count must be a power of two, got {C}")
    if out_major not in ("row", "col"):
        raise ValueError(f"unknown out_major {out_major!r}")
    if epilogue is not None:
        _check_epilogue(epilogue, (C, L), xr.device, "matfft_cols")
    return B, L, C


# ---------------------------------------------------------------------------
# the kernels' wrappers

_c_ptr, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BOUND = threading.Event()


def _lib() -> ctypes.CDLL:
    lib = build.load("matfft")
    if not _BOUND.is_set():
        lib.matfft_rows.argtypes = [_c_ptr] * 4 + [_c_ll] + [_c_int] * 3 + \
            [_c_ptr] * 8 + [_c_int, _c_ptr]
        lib.matfft_rows.restype = _c_int
        lib.matfft_cols.argtypes = [_c_ptr] * 4 + [_c_ll] + [_c_int] * 4 + \
            [_c_ptr] * 8 + [_c_int, _c_ptr]
        lib.matfft_cols.restype = _c_int
        _BOUND.set()
    return lib


def _kernel_args(tables, n: int):
    p = fft_plan.make_plan(n)
    ptrs = [t.data_ptr() for t in tables]
    if n <= DIRECT_N:
        return 0, 0, ptrs + [None] * 4
    return p.n1, p.n2, ptrs


def _check_cuda(xr, what: str) -> None:
    if xr.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{xr.device}")


def _contiguous(*ts, what: str) -> None:
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")


def matfft(xr: torch.Tensor, xi: torch.Tensor, *,
           epilogue: Planar | None = None,
           global_twiddle=None) -> Planar:
    """Batched forward DFT along the last axis of planar (rows, n) float32
    tensors, n a power of two <= MAX_LEAF.

    epilogue: optional planar (period, n) table, period a power of two;
      output row r is multiplied by ``epilogue[r % period]``.
    global_twiddle: the distributed placement's on-the-fly twiddle; not in
      this slice (ROADMAP Queue 1 item 7).
    """
    if global_twiddle is not None:
        raise NotImplementedError(
            "matfft global_twiddle belongs to the distributed placement "
            "(ROADMAP Queue 1 item 7)")
    if xr.device.type == "cpu":
        return matfft_plain(xr, xi, epilogue=epilogue)
    _check_cuda(xr, "matfft")
    rows, n = _check_rows(xr, xi, epilogue)
    er, ei = epilogue if epilogue is not None else (None, None)
    _contiguous(xr, xi, er, ei, what="matfft")
    n1, n2, tabs = _kernel_args(leaf_tables(n, xr.device), n)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    rc = _lib().matfft_rows(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows, n,
        n1, n2, *tabs,
        er.data_ptr() if er is not None else None,
        ei.data_ptr() if ei is not None else None,
        er.shape[0] if er is not None else 1,
        torch.cuda.current_stream(xr.device).cuda_stream)
    if rc:
        raise RuntimeError(f"matfft kernel launch failed: CUDA error {rc}")
    matfft.launches += 1
    return yr, yi


matfft.launches = 0


def matfft_cols(xr: torch.Tensor, xi: torch.Tensor, *,
                out_major: str = "row", epilogue: Planar | None = None,
                global_twiddle=None, col_offset: int = 0,
                ncols: int | None = None) -> Planar:
    """Batched forward DFT along the MIDDLE axis of planar (B, L, C) float32
    tensors; L a power of two <= MAX_LEAF, C a power of two.

    Logical batch row r = b*C + c transforms the column x[b, :, c].
    out_major: "row" returns (B*C, L) with row b*C + c; "col" returns
      (B, L, C) with out[b, o, c] — the transformed axis stays in place.
    epilogue: optional planar (C, L) table; output row (b, c) is
      multiplied by ``epilogue[c]``.
    global_twiddle, col_offset, ncols: the distributed placement's
      on-the-fly twiddle and column-slab reads; not in this slice (ROADMAP
      Queue 1 item 7).
    """
    if global_twiddle is not None or col_offset or (
            ncols is not None and ncols != xr.shape[-1]):
        raise NotImplementedError(
            "matfft_cols global_twiddle and column slabs belong to the "
            "distributed placement (ROADMAP Queue 1 item 7)")
    if xr.device.type == "cpu":
        return matfft_cols_plain(xr, xi, out_major=out_major,
                                 epilogue=epilogue)
    _check_cuda(xr, "matfft_cols")
    B, L, C = _check_cols(xr, xi, out_major, epilogue)
    er, ei = epilogue if epilogue is not None else (None, None)
    _contiguous(xr, xi, er, ei, what="matfft_cols")
    n1, n2, tabs = _kernel_args(leaf_tables(L, xr.device), L)
    shape = (B * C, L) if out_major == "row" else (B, L, C)
    yr = torch.empty(shape, dtype=torch.float32, device=xr.device)
    yi = torch.empty(shape, dtype=torch.float32, device=xr.device)
    rc = _lib().matfft_cols(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), B, L, C,
        n1, n2, *tabs,
        er.data_ptr() if er is not None else None,
        ei.data_ptr() if ei is not None else None,
        int(out_major == "col"),
        torch.cuda.current_stream(xr.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"matfft_cols kernel launch failed: CUDA error {rc}")
    matfft_cols.launches += 1
    return yr, yi


matfft_cols.launches = 0


def reset_counts() -> None:
    """Zero every launch and plain-call counter of this module."""
    matfft.launches = matfft_cols.launches = 0
    matfft_plain.calls = matfft_cols_plain.calls = 0
