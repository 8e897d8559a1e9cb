"""FFT planning helpers: factorizations and twiddle tables.

The paper's CUFFT "batched plan" becomes a static factorization of the
transform length into matrix-DFT factors plus precomputed twiddle tables,
which the leaf kernels (csrc/matfft.cu) read from device memory.
Everything here is host-side numpy (float64 internally, cast on export) and
cached — the analogue of ``cufftPlanMany`` construction. The tables are
bit-identical to the JAX package's.

Naming follows the classic four-step (Bailey) decomposition of a length-N
DFT with N = n1 * n2, input index i = i1*n2 + i2, output index o = o2*n1 + o1:

    A[o1, i2] = sum_i1 x[i1, i2] * W_{n1}^{i1*o1}        (column DFTs)
    B[o1, i2] = A[o1, i2] * W_N^{o1*i2}                  (twiddle)
    C[o1, o2] = sum_i2 B[o1, i2] * W_{n2}^{i2*o2}        (row DFTs)
    X[o2*n1 + o1] = C[o1, o2]                            (transpose)
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

# Maximum transform length handled by one leaf kernel call. A Hopper block
# holds its whole row in shared memory and transforms it in place: 4096
# complex points (32 KiB of planar f32 plus the padded intermediates of
# its radix passes) with 256 threads keeping 16 points each in registers.
# Longer rows take the level-1 four-step over two leaf passes.
MAX_LEAF = 4096


# K2's column group: the columns of one 32-byte sector of a float32 row,
# the most blocks a thread-block cluster may have on every Hopper card,
# and the shortest L that forms one (shorter tiles have an odd row pitch,
# and gain nothing over 8 columns of a few rows) (csrc/matfft.cu:
# CLUSTER_COLS, MAX_CLUSTER, CLUSTER_MIN_N)
CLUSTER_COLS = 8
MAX_CLUSTER = 8
CLUSTER_MIN_L = 32


def col_cluster(L: int, nc: int, aligned: bool = True) -> tuple[int, int]:
    """(R, K) of a K2 launch at length L over a slab of nc columns: R =
    min(MAX_LEAF // L, nc) the columns one block transforms, K the blocks
    of its thread-block cluster. A block of fewer than CLUSTER_COLS
    columns would read part of every sector it moves, so where R <
    CLUSTER_COLS <= nc (L >= 1024), K = CLUSTER_COLS // R blocks share
    one group of CLUSTER_COLS columns (2 at L = 1024, 4 at 2048, 8 at
    4096); else, or where the planes do not start on 16 bytes
    (``aligned`` false: the cluster moves 16 bytes at a time), K = 1, one
    block alone. The one place that decides it: the wrapper passes K to the kernel, which
    checks it (`check_col_cluster` mirrors the check)."""
    R = max(min(MAX_LEAF // max(L, 1), nc), 1)
    K = CLUSTER_COLS // R if R < CLUSTER_COLS <= nc and aligned else 1
    return R, K


def check_col_cluster(L: int, R: int, nc: int, K: int,
                      aligned: bool = True) -> None:
    """Raise ValueError for an (R, K) at length L over nc columns that K2
    refuses (csrc/matfft.cu:check_cluster): R a power of two dividing nc,
    and K = 1, or K a power of two <= MAX_CLUSTER with K * R =
    CLUSTER_COLS, nc / R a multiple of K, L >= CLUSTER_MIN_L and the
    planes 16-byte ``aligned``."""
    if not is_pow2(R) or nc % R:
        raise ValueError(f"K2 tile of {R} columns over {nc}")
    if K != 1 and not (is_pow2(K) and K <= MAX_CLUSTER
                       and K * R == CLUSTER_COLS and (nc // R) % K == 0
                       and L >= CLUSTER_MIN_L and aligned):
        raise ValueError(f"K2 cluster of {K} blocks of {R} columns over "
                         f"{nc} at L={L}: K * R must be {CLUSTER_COLS}, K "
                         f"<= {MAX_CLUSTER}, nc / R a multiple of K, L >= "
                         f"{CLUSTER_MIN_L}, the planes 16-byte aligned")


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def log2i(n: int) -> int:
    if not is_pow2(n):
        raise ValueError(f"length must be a power of two, got {n}")
    return n.bit_length() - 1


def split_pow2(n: int, max_leaf: int = MAX_LEAF) -> tuple[int, int]:
    """Split n = n1 * n2 (both pow2, both <= max_leaf), near-square.

    Near-square factors minimize total GEMM MACs: cost ~ N*(n1 + n2).
    """
    p = log2i(n)
    n1 = 1 << (p // 2)
    n2 = 1 << (p - p // 2)  # n2 >= n1
    if n2 > max_leaf:
        raise ValueError(f"cannot split {n} into factors <= {max_leaf}")
    return n1, n2


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Planar (re, im) forward DFT matrix W[i, o] = exp(-2j*pi*i*o/n), f32."""
    idx = np.arange(n, dtype=np.float64)
    ang = -2.0 * math.pi * np.outer(idx, idx) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def radix_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Planar roots of unity W_n^k = exp(-2j*pi*k/n), k in [0, n), f32.

    Every twiddle of the leaf's radix FFT (csrc/matfft.cu) is one of
    them: a stage twiddle W_{2l}^j is entry j*n/(2l), an inner twiddle
    W_n^{i2*o1} entry i2*o1.
    """
    ang = -2.0 * math.pi * np.arange(n, dtype=np.float64) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def twiddle_table(n1: int, n2: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Planar inner twiddle T[o1, i2] = exp(-2j*pi*o1*i2/n), shape (n1, n2)."""
    o1 = np.arange(n1, dtype=np.float64)
    i2 = np.arange(n2, dtype=np.float64)
    ang = -2.0 * math.pi * np.outer(o1, i2) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def rfft_twiddle(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Planar packing twiddle v[k] = exp(-2j*pi*k/n), shape (1, n//2).

    Combines the even/odd sub-spectra of the half-length packed transform
    into the one-sided real-input spectrum (matfft._rfft_kernel).
    """
    k = np.arange(n // 2, dtype=np.float64)
    ang = -2.0 * math.pi * k / n
    return (np.cos(ang).astype(np.float32).reshape(1, -1),
            np.sin(ang).astype(np.float32).reshape(1, -1))


@functools.lru_cache(maxsize=None)
def global_twiddles(n: int) -> tuple[int, np.ndarray, np.ndarray,
                                      np.ndarray, np.ndarray]:
    """The distributed four-step's twiddle W_n^m, m < n, as two tables.

    W_n^m = W_n^{(m >> k) << k} * W_n^{m & (2^k - 1)}, k = ceil(log2(n)/2):
    returns (k, hi_r, hi_i, lo_r, lo_i), f32, the high table of n >> k
    entries W_n^{j << k} and the low one of 2^k entries W_n^j. The leaf
    kernels' global-twiddle epilogue (csrc/matfft.cu) multiplies one entry
    of each, so no sin/cos is evaluated on the card.
    """
    k = (log2i(n) + 1) // 2

    def roots(m):
        ang = -2.0 * math.pi * (m / n)
        return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)

    hi = roots(np.arange(n >> k, dtype=np.float64) * (1 << k))
    lo = roots(np.arange(1 << k, dtype=np.float64))
    return (k, *hi, *lo)


@functools.lru_cache(maxsize=None)
def stockham_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Packed per-stage twiddles for the radix-2 Stockham kernel.

    Stage s (s = 0..log2(n)-1) uses l = n >> (s+1) twiddles
    w_j = exp(-2j*pi*j/(2l)), j in [0, l). They are packed contiguously:
    stage 0 at offset 0 (l = n/2), stage 1 at offset n/2 (l = n/4), ...
    Total packed length = n - 1; padded to n for a clean block shape.
    """
    re = np.zeros((n,), dtype=np.float32)
    im = np.zeros((n,), dtype=np.float32)
    off = 0
    l = n // 2
    while l >= 1:
        j = np.arange(l, dtype=np.float64)
        ang = -2.0 * math.pi * j / (2 * l)
        re[off:off + l] = np.cos(ang)
        im[off:off + l] = np.sin(ang)
        off += l
        l //= 2
    return re, im


def stockham_stage_offsets(n: int) -> list[tuple[int, int, int]]:
    """[(offset, l, m)] per stage for the packed twiddle layout above."""
    out = []
    off, l, m = 0, n // 2, 1
    while l >= 1:
        out.append((off, l, m))
        off += l
        l //= 2
        m *= 2
    return out


@dataclass(frozen=True)
class FftPlan:
    """Execution plan for a batched 1-D FFT of length ``n``.

    levels == 1: single kernel call (n <= max_leaf).
    levels == 2: host-level four-step with leaf kernel calls on both passes.
    levels == 3: host-level four-step whose second pass (n2 > max_leaf) is
                 itself a level-2 four-step (n <= max_leaf**3).
    (Distributed cross-device planning lives in core/fft/distributed.py and
    composes on top of this plan for the per-device local work.)
    """

    n: int
    levels: int
    n1: int  # levels>=2: outer factor (column count);   levels==1: the
    n2: int  # levels>=2: inner factor (row FFT length); reference leaf's split

    @property
    def flops(self) -> float:
        """Algorithmic complex-FLOPs (5 n log2 n), the roofline numerator."""
        return 5.0 * self.n * log2i(self.n)

    @property
    def gemm_macs(self) -> float:
        """Real MACs the reference's matmul formulation issues per batch
        row (its direct DFT and four-step leaves); the port's leaf runs a
        radix FFT instead, so this counts the reference, not the port."""
        if self.levels == 1:
            return 4.0 * self.n * (self.n1 + self.n2)
        f1 = split_pow2(self.n1)
        if self.levels == 3:
            return (4.0 * self.n * (f1[0] + f1[1])
                    + self.n1 * make_plan(self.n2).gemm_macs)
        f2 = split_pow2(self.n2)
        return 4.0 * self.n * (f1[0] + f1[1] + f2[0] + f2[1])


# ---------------------------------------------------------------------------
# analytic HBM traffic counters (the roofline byte numerators; see DESIGN.md
# §3-4 and benchmarks/bench_fft.py). All counts are planar-f32 payload bytes
# per batch row, ignoring the O(table) twiddle/DFT-matrix operands.

_F32 = 4  # bytes


def fft_hbm_bytes(n: int, layout: str = "zero_copy",
                  max_leaf: int = MAX_LEAF) -> int:
    """HBM bytes moved per batch row by the complex transform.

    levels == 1: one kernel pass — read 2 planes, write 2 planes.
    levels == 2, zero_copy: two passes, each read+write (4 traversals).
    levels == 2, copy (legacy): the three materialized transposes
    (to_cols / to_rows / out_order) each add a full read+write on top.
    levels == 3: the second pass is a level-2 transform of length n2; on
    the zero_copy path it runs between two materialized transposes
    (executors.axis_pass), which add two read+writes.
    """
    p = make_plan(n, max_leaf)
    plane = _F32 * n
    per_pass = 2 * 2 * plane  # 2 planes in + 2 planes out
    if p.levels == 1:
        return per_pass
    second = (n // p.n2) * fft_hbm_bytes(p.n2, layout, max_leaf)
    if layout == "zero_copy":
        return per_pass + second + (2 * per_pass if p.levels == 3 else 0)
    return per_pass + second + 3 * per_pass  # + transpose round-trips


def rfft_hbm_bytes(n: int, max_leaf: int = MAX_LEAF) -> int:
    """HBM bytes moved per batch row by the real-input fast path.

    Leaf regime (n//2 a leaf length): the fused kernel reads the real
    buffer once and writes the one-sided planar spectrum — nothing else
    touches HBM. Level-1 regime: host pack + half-length zero-copy
    transform + vectorized untangle.
    """
    m = n // 2
    plane_n = _F32 * n
    out_sided = 2 * _F32 * (m + 1)
    if make_plan(m, max_leaf).levels == 1:
        return plane_n + out_sided  # read real input, write spectrum
    pack = plane_n + 2 * _F32 * m          # read x, write (zr, zi)
    untangle = 2 * 2 * _F32 * m + out_sided  # read Y, write spectrum
    return pack + fft_hbm_bytes(m, "zero_copy", max_leaf) + untangle


def fftn_hbm_bytes(shape, layout: str = "zero_copy",
                   max_leaf: int = MAX_LEAF) -> int:
    """HBM bytes moved per batch row (one image/volume) by the N-D c2c
    transform over the trailing ``len(shape)`` axes.

    zero_copy: the contiguous (last) axis runs the 1-D row-major path
    (level-0/1, see fft_hbm_bytes); every earlier axis is ONE column-strided
    pass — read 2 planes + write 2 planes of the whole image, with the
    transpose absorbed into the kernel's BlockSpec. No transposed tensor
    ever lands in HBM between passes.

    copy (the naive baseline bench_fft2.py gates against): each
    non-contiguous axis is brought to the minor position by a materialized
    swapaxes, row-FFT'd, and swapped back — two extra full round-trips of
    the image per axis on top of the pass itself.

    An earlier axis longer than one leaf (`earlier_axis_hbm_bytes`) runs
    between two materialized transposes in either layout.
    """
    shape = tuple(int(d) for d in shape)
    n_last = shape[-1]
    total_n = math.prod(shape)
    total = (total_n // n_last) * fft_hbm_bytes(n_last, layout, max_leaf)
    for d in shape[:-1]:
        total += earlier_axis_hbm_bytes(d, total_n, layout, max_leaf)
    return total


def earlier_axis_hbm_bytes(length: int, points: int,
                           layout: str = "zero_copy",
                           max_leaf: int = MAX_LEAF) -> int:
    """HBM bytes of one earlier-axis pass of length ``length`` over an
    image or volume of ``points`` complex points (executors.axis_pass).

    Up to one leaf on the zero-copy path: ONE column-strided pass, read 2
    planes + write 2 planes. Otherwise the axis is brought to the minor
    position by a materialized transpose, transformed as
    ``points // length`` rows (level 0, or the level-1 four-step past
    ``max_leaf``), and transposed back: two extra round trips.
    """
    per_pass = 2 * 2 * _F32 * points  # 2 planes in + 2 planes out
    if layout == "zero_copy" and length <= max_leaf:
        return per_pass
    return ((points // length) * fft_hbm_bytes(length, layout, max_leaf)
            + 2 * per_pass)


def rfftn_hbm_bytes(shape, max_leaf: int = MAX_LEAF) -> int:
    """HBM bytes per batch row for the N-D real-input fast path.

    The packed-real trick rides the contiguous axis: n_last reals enter as
    n_last/2 complex via a free reshape, the remaining axes transform the
    half-width spectrum (conjugate untangle commutes with the other axes'
    DFTs — both are linear maps over different axes), and ONE vectorized
    untangle epilogue widens m -> m+1 bins at the end.
    """
    shape = tuple(int(d) for d in shape)
    if len(shape) == 1:
        return rfft_hbm_bytes(shape[0], max_leaf)
    n_last = shape[-1]
    m = n_last // 2
    rows_last = math.prod(shape[:-1])
    half_n = rows_last * m  # complex points after packing
    # pass over the contiguous axis: the fused kernel (rfft_pack_leaf)
    # reads the real rows and writes the packed half-spectrum planes; when
    # the half transform is level-1 the pack happens on the host (one
    # round trip) before the full half-length zero-copy transform
    pass_a = rows_last * (_F32 * n_last + 2 * _F32 * m)
    if make_plan(m, max_leaf).levels != 1:
        pass_a += rows_last * fft_hbm_bytes(m, "zero_copy", max_leaf)
    passes_rest = sum(earlier_axis_hbm_bytes(d, half_n, "zero_copy",
                                             max_leaf)
                      for d in shape[:-1])
    untangle = 2 * 2 * _F32 * half_n + 2 * _F32 * rows_last * (m + 1)
    return pass_a + passes_rest + untangle


def make_plan(n: int, max_leaf: int = MAX_LEAF) -> FftPlan:
    if n <= max_leaf:
        n1, n2 = (1, n) if n <= 2 else split_pow2(n, max_leaf)
        return FftPlan(n=n, levels=1, n1=n1, n2=n2)
    if n <= max_leaf * max_leaf:
        n1, n2 = split_pow2(n, max_leaf)
        return FftPlan(n=n, levels=2, n1=n1, n2=n2)
    # near-cube: a leaf-sized first pass, a level-2 second pass
    n1 = 1 << (log2i(n) // 3)
    n2 = n // n1
    if n1 > max_leaf or n2 > max_leaf * max_leaf:
        raise ValueError(f"cannot plan {n} in three levels of {max_leaf}")
    return FftPlan(n=n, levels=3, n1=n1, n2=n2)
