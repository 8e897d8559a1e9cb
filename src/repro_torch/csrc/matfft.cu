// Hand-written Hopper kernels for the leaf transforms.
//
//   matfft_rows   K1: DFT along the last axis of planar (rows, n) f32.
//                 Replaces repro/kernels/fft/matfft.py:matfft (Pallas bodies
//                 _dft_kernel and _matfft_kernel).
//   matfft_cols   K2: DFT along the MIDDLE axis of planar (B, L, C) f32,
//                 or of an aligned slab of its columns, stored row-major
//                 (B*C, L) or column-major (B, L, C).
//                 Replaces repro/kernels/fft/matfft.py:matfft_cols (Pallas
//                 body _col_kernel): the pallas_call at matfft.py:438 for
//                 512 <= L <= 4096 (cols_kernel<false>) and at :419 below
//                 (cols_kernel<true>).
//
// All three run one tile algebra on TILE = 4096 complex points a block
// (R = TILE / n whole rows, or R columns of one (L, C) matrix for K2). K2,
// and K1 and K3 at n <= 256, stage the tile in shared memory in natural
// order, transform it in place (tile_dft below), and store it with the
// optional epilogue (K1, K2) or the untangle (K3) fused into the store. K1
// and K3 at n >= 512 stage no tile (rows_radix3, rfft_radix3): the first
// pass loads its rows from device memory straight into registers, and
// only the two intermediates between the passes go through shared memory.
// K1's last pass applies the epilogue in registers and stores straight to
// device memory, as does K3's without the untangle; K3's with it writes
// each row's spectrum to shared memory once, and untangles pairs of bins
// from there (rfft_radix3 says how).
//
// The tile algebra is a radix FFT for every n <= TILE. Its passes are
// DFTs of at most RADIX = 16 points, each run in one thread's registers
// (reg_dft: the radix-2 butterflies of the plain version's Stockham
// stages, kept in place), with an inner twiddle between two passes. With
// i = i1*b + i2, o = o2*a + o1:
//
//   n <= 256   two passes (tile_radix), n = a * b, a = min(n, RADIX):
//                A[o1, i2] = W_n^{i2*o1} * DFT_a(x[. * b + i2])[o1]
//                y[o2*a + o1] = DFT_b(A[o1, .])[o2]
//   n >= 512   three passes (tile_radix3), n = 16 * b, b = 16 * c,
//              c in {2, 4, 8, 16}: the same first pass with a = 16, then
//              the b-point DFT over i2 as the two passes above at length b
//              (16 points over i2a, i2 = i2a*c + i2b, the inner twiddle
//              W_b^{i2b*o2} = W_n^{16*i2b*o2}, then c points over i2b);
//              output o = (o3*16 + o2)*16 + o1.
//
// Each kernel has two instantiations, one for each of these, so that each
// gets the registers its own passes need. The reference's matrix DFTs
// (one product with the (n, n) DFT matrix up to 256 points, the four-step
// of products with W_{n1}, T and W_{n2} above) are replaced, not ported.
//
// Every twiddle is an entry W_n^k, k < n, of the plan's (n,) float32
// table (kernels/fft/plan.py:radix_twiddles, computed in float64 on the
// host), read through the read-only cache: a stage twiddle W_{2l}^j is
// entry j*n/(2l), an inner twiddle entry i2*o1 or 16*i2b*o2. No sin/cos
// is evaluated on the card.
//
// What bounds it on an H100. An FFT of n points does about 5 n log2 n
// flops (40 a point at n = 256, 60 at n = 4096) against 16 bytes a point
// of device memory traffic, at most about 4 flops a byte, far below the
// card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20): it is bound by
// bytes. The design reads and writes device memory once a point each way,
// coalesced, and keeps shared memory to one round trip a pass: each of
// 256 threads reads its 16 points into registers, runs its DFTs there,
// and writes back once, through strides chosen so that no access has a
// bank conflict (make_geom says how). K1's three passes take the first
// read and the last write from device memory itself (4 shared-memory
// accesses a point and 3 block-wide syncs, against 8 and 7 where the tile
// is staged in and out; K3's untangle 6 and 5, against 9 and 7). Both
// instantiations are held to 64 registers a thread, so that four blocks
// (1024 threads, 33-50 KB of shared memory each) fit a SM. IEEE f32 on the CUDA cores, no TF32 and
// no tensor cores; every product and sum is rounded as the plain PyTorch
// version rounds it (__fmul_rn, __fadd_rn: no contraction), so each
// kernel equals its plain version bit for bit.
//
//   matfft_rfft   K3: one-sided spectrum of real (rows, n) f32, n = 2m.
//                 Replaces repro/kernels/fft/matfft.py:_rfft_pallas (Pallas
//                 body _rfft_kernel, fused untangle_half_spectrum), behind
//                 rfft_leaf and rfft_pack_leaf.
//
// K3 packs z[k] = x[2k] + i x[2k+1] as it loads (one 8-byte float2 read
// per complex point, so the packing costs nothing), runs the tile algebra
// at the half length m with R = TILE / m whole rows a block, and
// untangles from a shared-memory row that holds Y[k] and its partner
// Y[(m-k) % m]: at m <= 256 in the store loop of the staged tile, above
// it a pair (k, m-k) a thread, each of the pair's words read once, with
// no division by the row width m+1. v[k] = W_n^k comes from the plan's
// rfft_twiddle table. It reads 4n bytes and writes 8(m+1) a row, half the
// traffic and about half the work of the complex transform of the same
// row. The output row stride m+1 is odd, so its stores are scalar.
//
// A row's result depends only on its own values: every output is a fixed
// sequence of operations on its own row, with no reduction across rows,
// so it is the same whatever the batch size or the row's place in it.
//
// Two options of K1 and K2 serve the distributed four-step
// (core/fft/distributed.py):
//
//   global twiddle  replaces repro/kernels/fft/matfft.py:_global_twiddle.
//                   The store multiplies output (row, o) by W_N^m, m =
//                   ((row0 + row) * o) mod N, N = n_global a power of two
//                   <= 2^32: the product wraps in 32-bit unsigned
//                   arithmetic and the mask reduces it exactly. W_N^m is
//                   the product of two entries of the plan's tables
//                   (kernels/fft/plan.py:global_twiddles, float64 on the
//                   host): W_N^{(m >> k) << k} * W_N^{m & (2^k - 1)}, k =
//                   ceil(log2 N / 2), then multiplied into the output, both
//                   rounded as cmul rounds. The reference computes cos and
//                   sin of an f32 angle on the fly; reading two small
//                   tables (at most 2^16 entries each, resident in L2)
//                   keeps the kernel equal to its plain version bit for
//                   bit. K1's row is its row index, K2's the slab-relative
//                   row b * ncols + c.
//   column slab     K2 transforms only the columns [col0, col0 + ncols) of
//                   the (B, L, C) operand, read in place (matfft.py:325):
//                   block tiles span R = min(TILE / L, ncols) columns of
//                   the slab, and the output is (B, L, ncols) or
//                   (B * ncols, L).
//
// The tile is fixed at the default above (K1: TILE / n rows, K2: min(TILE
// / L, ncols) columns, K3: TILE / m rows): a block keeps its 256 threads
// whatever it stages, so a narrower tile only leaves threads idle and fits
// no more blocks on a SM.
//
// K2's column group. K2 moves 16 bytes a point of device memory for about
// 5 log2 L flops (at most about 4 flops a byte): like K1, it is bound by
// bytes, and what it must get right is the load and the store. Its
// operand is read down the columns: a matrix row holds one value of each
// column, and a 32-byte sector of a float32 plane holds G = 8 adjacent
// columns (CLUSTER_COLS). A block of R >= G columns reads whole sectors;
// one of R < G columns (L >= 1024: R = 4096 / L) would use R * 4 of every
// 32 bytes it moves, an eighth at L = 4096. So a
// launch with R < G <= ncols runs as thread-block clusters of K = G / R
// blocks (2 at L = 1024, 4 at 2048, 8 at 4096), one cluster a group of G
// adjacent columns of one matrix; which launches do is decided in one
// place, kernels/fft/plan.py:col_cluster, and checked here. Block k of a
// cluster reads rows [k*L/K, (k+1)*L/K) of all G columns, whole sectors,
// and stores each value straight into the shared memory of the block that
// owns its column (distributed shared memory: mapa and
// st.shared::cluster, what cooperative_groups' map_shared_rank gives).
// After a cluster barrier each block runs tile_dft on its own R columns,
// unchanged, so every output is the same bits as on the one-block path
// and as the plain version. A column-major store then goes the same way
// back: block k reads output rows [k*L/K, (k+1)*L/K) of all G columns
// from its peers' shared memory (ld.shared::cluster) and writes them in
// whole sectors; a row-major store is contiguous along o already, and
// each block writes its own columns. Shared memory stays one tile a block
// (make_geom), so four blocks still fit a SM.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int P = 16;           // outputs held by each thread
constexpr int TILE = NT * P;    // complex points per block; the longest
                                // row, kernels/fft/plan.py:MAX_LEAF
constexpr int LOG_RADIX = 4;    // passes of at most RADIX = P points,
constexpr int RADIX = 1 << LOG_RADIX;  // held by one thread
constexpr int TWO_PASS_N = RADIX * RADIX;  // longest two-pass length
constexpr int MIN_BLOCKS = 4;   // blocks a SM: 64 registers a thread
constexpr int MAX_SMEM = 64 * 1024;
// tile_radix3's intermediates (make_geom): the first pass's output at
// (r*16 + o1) * (b + M1_PAD) + i2, the second's at d * M2_STRIDE + o2*16
// + o1 with d = r*c + i2b
constexpr int M1_PAD = 2;
constexpr int M2_STRIDE = (RADIX + 1) * RADIX;
// K2's cluster path: G, the columns of one 32-byte sector of a float32
// row (kernels/fft/plan.py:CLUSTER_COLS), the portable cluster size, and
// the (column, 4 rows) units a thread moves at a full tile; the shortest
// L a cluster takes (below it make_geom's ld is odd, and 16-byte moves
// misalign; kernels/fft/plan.py:CLUSTER_MIN_L)
constexpr int CLUSTER_COLS = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int CLUSTER_MIN_N = 32;
constexpr int UNITS = TILE / (4 * NT);

struct Geom {
  int n, log_n;     // transform length
  int R, log_R;     // rows (K2: columns) staged per block
  int ld;           // shared-memory row stride, in floats
  int plane;        // floats of one plane (real or imaginary) of the tile
  int log_w;        // two-pass branch: a warp takes 2^log_w adjacent
                    // columns of 32 / 2^log_w rows (make_geom)
};

// (ar + i ai) * (br + i bi), rounded as the plain PyTorch version rounds it
__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& yr, float& yi) {
  yr = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
  yi = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
}

// The global-twiddle epilogue's arguments (hr == nullptr: off): the high
// table W_N^{j << k}, j < N >> k, the low table W_N^j, j < 2^k, the mask
// N - 1 and the logical row of the call's row 0.
struct GTw {
  const float *hr, *hi, *lr, *li;
  unsigned long long row0;
  unsigned mask;
  int k;
};

// v *= W_N^m, m = ((row0 + row) * o) mod N (plain version:
// kernels/fft/matfft.py:apply_global_twiddle)
__device__ __forceinline__ void global_twiddle(const GTw& t, long long row,
                                               int o, float& vr, float& vi) {
  const unsigned m =
      ((unsigned)(t.row0 + (unsigned long long)row) * (unsigned)o) & t.mask;
  const unsigned h = m >> t.k, l = m & ((1u << t.k) - 1u);
  float wr, wi;
  cmul(__ldg(t.hr + h), __ldg(t.hi + h), __ldg(t.lr + l), __ldg(t.li + l),
       wr, wi);
  cmul(vr, vi, wr, wi, vr, vi);
}

// K1's store epilogue at output (row, o) of rows of n: the periodic
// table's row row mod period, or the global twiddle, or nothing
__device__ __forceinline__ void rows_epilogue(const float* __restrict__ er,
                                              const float* __restrict__ ei,
                                              int period, const GTw& gt,
                                              long long row, int n, int o,
                                              float& vr, float& vi) {
  if (er != nullptr) {
    const int e = (int)(row & (period - 1)) * n + o;
    cmul(vr, vi, __ldg(er + e), __ldg(ei + e), vr, vi);
  } else if (gt.hr != nullptr) {
    global_twiddle(gt, row, o, vr, vi);
  }
}

// K2's store epilogue at output (column, o): the periodic table's row
// erow, or the global twiddle at logical row grow, or nothing
__device__ __forceinline__ void cols_epilogue(const float* __restrict__ er,
                                              const float* __restrict__ ei,
                                              const GTw& gt, int erow,
                                              long long grow, int L, int o,
                                              float& vr, float& vi) {
  if (er != nullptr) {
    const int e = erow * L + o;
    cmul(vr, vi, __ldg(er + e), __ldg(ei + e), vr, vi);
  } else if (gt.hr != nullptr) {
    global_twiddle(gt, grow, o, vr, vi);
  }
}

// Distributed shared memory of a thread-block cluster (sm_90). Addresses
// are 32-bit shared-window offsets: smem_addr of this block's pointer,
// peer_addr of the same offset in block `rank` of the cluster.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer4(unsigned addr, const float (&v)[4]) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

__device__ __forceinline__ void ld_peer4(unsigned addr, float (&v)[4]) {
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr) : "memory");
}

// The cluster barrier, split: arrive (release; relaxed: orders nothing)
// and wait (acquire). Every thread of every block of the cluster calls
// them in turn, arrive then wait, at the same points.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Bit reversal of the low `bits` bits of v, bits <= LOG_RADIX. No loop,
// so that it folds to a constant wherever v and bits are (a loop here is
// left rolled when its caller is unrolled, and v then leaves registers).
__device__ __forceinline__ constexpr int brev(int v, int bits) {
  return (((v & 1) << 3) | ((v & 2) << 1) | ((v & 4) >> 1) |
          ((v & 8) >> 3)) >> (LOG_RADIX - bits);
}

// The 2^LOG_M-point DFT of v[off, off + 2^LOG_M) in registers, in place:
// output o lands in v[off + brev(o, LOG_M)]. The butterflies are those of
// the plain version's radix-2 Stockham stages (matfft.py:stockham_stages),
// in decimation-in-frequency order and rounded the same way: stage s pairs
// a = v[i], b = v[i + l] within each block of 2l (l = M >> (s+1)) and
// writes a + b and (a - b) * w_j, j = i mod l, w_j = W_{2l}^j = entry
// j*N/(2l) of the W_N table. Kept in place, they leave the outputs in
// bit-reversed order instead of the Stockham stages' natural order, with
// no second array. w_0 = 1 exactly, so its product is skipped (the same
// value, up to the sign of a zero). off must be a constant after
// unrolling, so that v stays in registers.
template <int LOG_M, int LOG_N>
__device__ __forceinline__ void reg_dft(float (&vr)[P], float (&vi)[P],
                                        const int off,
                                        const float* __restrict__ twr,
                                        const float* __restrict__ twi) {
  constexpr int M = 1 << LOG_M;
#pragma unroll
  for (int s = 0; s < LOG_M; ++s) {
    const int l = M >> (s + 1);
    const int step = 1 << (LOG_N - LOG_M + s);  // N / (2l)
#pragma unroll
    for (int j = 0; j < l; ++j) {
      const float wr = j ? __ldg(twr + j * step) : 1.f;
      const float wi = j ? __ldg(twi + j * step) : 0.f;
#pragma unroll
      for (int blk = 0; blk < M; blk += 2 * l) {
        const int ia = off + blk + j, ib = ia + l;
        const float ar = vr[ia], ai = vi[ia], br = vr[ib], bi = vi[ib];
        vr[ia] = __fadd_rn(ar, br);
        vi[ia] = __fadd_rn(ai, bi);
        const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
        if (j) {
          vr[ib] = __fsub_rn(__fmul_rn(wr, dr), __fmul_rn(wi, di));
          vi[ib] = __fadd_rn(__fmul_rn(wr, di), __fmul_rn(wi, dr));
        } else {
          vr[ib] = dr;
          vi[ib] = di;
        }
      }
    }
  }
}

// The (row, column) pair of item p of a pass over R rows x C columns: a
// warp's 32 items take 2^lw adjacent columns of 32 / 2^lw adjacent rows.
// p < R * C is a bijection onto the pairs.
__device__ __forceinline__ void pair_of(int p, int lw, int log_R, int& r,
                                        int& c) {
  r = (p >> lw) & ((1 << log_R) - 1);
  c = ((p >> (lw + log_R)) << lw) | (p & ((1 << lw) - 1));
}

// tile_dft at n = 2^LOG_N <= 256, in two passes: n = A * B, A =
// min(n, RADIX). Pass 1: item (r, i2) reads x[i1*B + i2], i1 < A, runs the
// A-point DFT (reg_dft) and multiplies output o1 by W_n^{i2*o1}; the block
// synchronises and writes the intermediate to r*ld + i2*(A+1) + o1. Pass 2
// (B > 1): item (r, o1) reads it over i2 < B, runs the B-point DFT and
// writes output o2 to r*ld + o2*A + o1, natural order. Each thread takes
// P / A items in pass 1 and P / B in pass 2, P points each time. For
// B == 1 pass 1's store is already in natural order.
template <int LOG_N>
__device__ __forceinline__ void tile_radix(float* sr, float* si,
                                           const Geom& g,
                                           const float* __restrict__ twr,
                                           const float* __restrict__ twi) {
  constexpr int LOG_A = LOG_N < LOG_RADIX ? LOG_N : LOG_RADIX;
  constexpr int LOG_B = LOG_N - LOG_A;
  constexpr int A = 1 << LOG_A, B = 1 << LOG_B;
  constexpr int KA = P / A, KB = P / B;  // items a thread, each pass
  constexpr int BS = A + 1;              // intermediate's stride over i2
  const int t = threadIdx.x, ld = g.ld;
  float vr[P], vi[P];

  {  // pass 1
    const int lw = g.log_w < LOG_B ? g.log_w : LOG_B;
    const int items = g.R << LOG_B;
#pragma unroll
    for (int k = 0; k < KA; ++k) {
      const int p = k * NT + t;
      int r, i2;
      pair_of(p, lw, g.log_R, r, i2);
#pragma unroll
      for (int i1 = 0; i1 < A; ++i1) {
        const int x = r * ld + i1 * B + i2;
        vr[k * A + i1] = p < items ? sr[x] : 0.f;
        vi[k * A + i1] = p < items ? si[x] : 0.f;
      }
      reg_dft<LOG_A, LOG_N>(vr, vi, k * A, twr, twi);
      if (LOG_B > 0 && p < items) {
#pragma unroll
        for (int o1 = 1; o1 < A; ++o1) {
          const int e = i2 * o1, q = k * A + brev(o1, LOG_A);
          cmul(vr[q], vi[q], __ldg(twr + e), __ldg(twi + e), vr[q], vi[q]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KA; ++k) {
      const int p = k * NT + t;
      int r, i2;
      pair_of(p, lw, g.log_R, r, i2);
      if (p < items) {
#pragma unroll
        for (int o1 = 0; o1 < A; ++o1) {
          sr[r * ld + i2 * BS + o1] = vr[k * A + brev(o1, LOG_A)];
          si[r * ld + i2 * BS + o1] = vi[k * A + brev(o1, LOG_A)];
        }
      }
    }
    __syncthreads();
  }
  if constexpr (LOG_B > 0) {  // pass 2
    const int lw = g.log_w < LOG_A ? g.log_w : LOG_A;
    const int items = g.R << LOG_A;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int p = k * NT + t;
      int r, o1;
      pair_of(p, lw, g.log_R, r, o1);
#pragma unroll
      for (int i2 = 0; i2 < B; ++i2) {
        const int x = r * ld + i2 * BS + o1;
        vr[k * B + i2] = p < items ? sr[x] : 0.f;
        vi[k * B + i2] = p < items ? si[x] : 0.f;
      }
      reg_dft<LOG_B, LOG_N>(vr, vi, k * B, twr, twi);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int p = k * NT + t;
      int r, o1;
      pair_of(p, lw, g.log_R, r, o1);
      if (p < items) {
#pragma unroll
        for (int o2 = 0; o2 < B; ++o2) {
          sr[r * ld + o2 * A + o1] = vr[k * B + brev(o2, LOG_B)];
          si[r * ld + o2 * A + o1] = vi[k * B + brev(o2, LOG_B)];
        }
      }
    }
    __syncthreads();
  }
}

// tile_dft at n = 2^LOG_N in [512, 4096], in three passes: n = 16 * B,
// B = 16 * C, i = i1*B + i2a*C + i2b (i2 = i2a*C + i2b), and a block
// stages RF = P / C rows (g.R <= RF: K2 may stage fewer), so that each
// pass has one item a thread, P points each.
//   Pass 1: item (r, i2) reads x[i1*B + i2], i1 < 16, runs the 16-point
//   DFT and multiplies output o1 by W_n^{i2*o1}; stores it to
//   M1 = (r*16 + o1) * (B + M1_PAD) + i2.
//   Pass 2: item (r, o1, i2b) reads M1 over i2a < 16, runs the 16-point
//   DFT and multiplies output o2 by W_B^{i2b*o2} = W_n^{16*i2b*o2}; stores
//   it to M2 = d * M2_STRIDE + o2*16 + o1, d = r*C + i2b.
//   Pass 3: item (o1, o2) reads M2 over every d: the C-point DFTs over
//   i2b of all RF rows, each at its own constant offset r*C of the
//   registers; stores output o3 of row r to r*ld + (o3*16 + o2)*16 + o1,
//   natural order.
// These are the two passes of tile_radix at length B, after a first pass
// at A = 16, with the same operations in the same order as the plain
// version's recursion (matfft.py:_radix_plain). The radix3_* helpers
// below are the passes' shared parts: tile_radix3 (K2) runs them on a
// staged tile, K1's rows_radix3 and K3's rfft_radix3 between device memory
// and registers.

// Pass 1's arithmetic on item (r, i2), its 16 inputs in v[0, 16): the
// 16-point DFT, then output o1 times W_n^{i2*o1} where the row is in the
// tile (on).
template <int LOG_N>
__device__ __forceinline__ void radix3_pass1(float (&vr)[P], float (&vi)[P],
                                             const int i2, const bool on,
                                             const float* __restrict__ twr,
                                             const float* __restrict__ twi) {
  reg_dft<LOG_RADIX, LOG_N>(vr, vi, 0, twr, twi);
  if (on) {
#pragma unroll
    for (int o1 = 1; o1 < RADIX; ++o1) {
      const int e = i2 * o1, q = brev(o1, LOG_RADIX);
      cmul(vr[q], vi[q], __ldg(twr + e), __ldg(twi + e), vr[q], vi[q]);
    }
  }
}

// Pass 1's store of item (r, i2) to M1.
template <int LOG_N>
__device__ __forceinline__ void radix3_store_m1(const float (&vr)[P],
                                                const float (&vi)[P],
                                                float* sr, float* si,
                                                const int r, const int i2) {
  constexpr int S1 = (1 << (LOG_N - LOG_RADIX)) + M1_PAD;  // over (r, o1)
#pragma unroll
  for (int o1 = 0; o1 < RADIX; ++o1) {
    const int x = (r * RADIX + o1) * S1 + i2;
    sr[x] = vr[brev(o1, LOG_RADIX)];
    si[x] = vi[brev(o1, LOG_RADIX)];
  }
}

// Pass 2, M1 to M2, for the g.R = R rows of the tile. M2 overwrites M1:
// the block synchronises between the loads and the stores, and after.
template <int LOG_N>
__device__ __forceinline__ void radix3_pass2(float* sr, float* si,
                                             const int R,
                                             const float* __restrict__ twr,
                                             const float* __restrict__ twi,
                                             float (&vr)[P], float (&vi)[P]) {
  constexpr int LOG_C = LOG_N - 2 * LOG_RADIX;
  constexpr int C = 1 << LOG_C;
  constexpr int S1 = (1 << (LOG_N - LOG_RADIX)) + M1_PAD;
  const int t = threadIdx.x;
  const int o1 = t & (RADIX - 1), d = t >> LOG_RADIX;
  const int r = d >> LOG_C, i2b = d & (C - 1);
  const bool on = r < R;
#pragma unroll
  for (int i2a = 0; i2a < RADIX; ++i2a) {
    const int x = (r * RADIX + o1) * S1 + i2a * C + i2b;
    vr[i2a] = on ? sr[x] : 0.f;
    vi[i2a] = on ? si[x] : 0.f;
  }
  reg_dft<LOG_RADIX, LOG_N>(vr, vi, 0, twr, twi);
  if (on) {
#pragma unroll
    for (int o2 = 1; o2 < RADIX; ++o2) {
      const int e = (i2b * o2) << LOG_RADIX, q = brev(o2, LOG_RADIX);
      cmul(vr[q], vi[q], __ldg(twr + e), __ldg(twi + e), vr[q], vi[q]);
    }
  }
  __syncthreads();
  if (on) {
#pragma unroll
    for (int o2 = 0; o2 < RADIX; ++o2) {
      const int x = d * M2_STRIDE + o2 * RADIX + o1;
      sr[x] = vr[brev(o2, LOG_RADIX)];
      si[x] = vi[brev(o2, LOG_RADIX)];
    }
  }
  __syncthreads();
}

// Pass 3's loads and DFT of row r (a constant after unrolling): item (o1,
// o2) reads M2 over d = r*C + i2b and runs the C-point DFT on v[r*C, r*C
// + C); output o3 lands in v[r*C + brev(o3)].
template <int LOG_N>
__device__ __forceinline__ void radix3_pass3(const float* sr,
                                             const float* si, const int R,
                                             const int r,
                                             const float* __restrict__ twr,
                                             const float* __restrict__ twi,
                                             float (&vr)[P], float (&vi)[P]) {
  constexpr int LOG_C = LOG_N - 2 * LOG_RADIX;
  constexpr int C = 1 << LOG_C;
  const int t = threadIdx.x;
  const int o1 = t & (RADIX - 1), o2 = t >> LOG_RADIX;
#pragma unroll
  for (int i2b = 0; i2b < C; ++i2b) {
    const int d = r * C + i2b, x = d * M2_STRIDE + o2 * RADIX + o1;
    vr[d] = r < R ? sr[x] : 0.f;
    vi[d] = r < R ? si[x] : 0.f;
  }
  reg_dft<LOG_C, LOG_N>(vr, vi, r * C, twr, twi);
}

template <int LOG_N>
__device__ __forceinline__ void tile_radix3(float* sr, float* si,
                                            const Geom& g,
                                            const float* __restrict__ twr,
                                            const float* __restrict__ twi) {
  constexpr int LOG_C = LOG_N - 2 * LOG_RADIX;
  constexpr int LOG_B = LOG_N - LOG_RADIX;
  constexpr int C = 1 << LOG_C, B = 1 << LOG_B;
  constexpr int RF = P / C;         // rows a full tile holds
  const int t = threadIdx.x, ld = g.ld, R = g.R;
  float vr[P], vi[P];

  {  // pass 1
    const int r = t >> LOG_B, i2 = t & (B - 1);
    const bool on = r < R;
#pragma unroll
    for (int i1 = 0; i1 < RADIX; ++i1) {
      const int x = r * ld + i1 * B + i2;
      vr[i1] = on ? sr[x] : 0.f;
      vi[i1] = on ? si[x] : 0.f;
    }
    radix3_pass1<LOG_N>(vr, vi, i2, on, twr, twi);
    __syncthreads();  // M1 overwrites the tile
    if (on) radix3_store_m1<LOG_N>(vr, vi, sr, si, r, i2);
    __syncthreads();
  }
  radix3_pass2<LOG_N>(sr, si, R, twr, twi, vr, vi);
#pragma unroll
  for (int r = 0; r < RF; ++r)
    radix3_pass3<LOG_N>(sr, si, R, r, twr, twi, vr, vi);
  __syncthreads();  // the output overwrites M2
  {
    const int o1 = t & (RADIX - 1), o2 = t >> LOG_RADIX;
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      if (r < R) {
#pragma unroll
        for (int o3 = 0; o3 < C; ++o3) {
          const int x = r * ld + (o3 * RADIX + o2) * RADIX + o1;
          sr[x] = vr[r * C + brev(o3, LOG_C)];
          si[x] = vi[r * C + brev(o3, LOG_C)];
        }
      }
    }
  }
  __syncthreads();
}

// Transforms g.R rows of length g.n held in shared memory (row r at
// s[r * g.ld]) in place, natural output order: in two passes (kTwoPass,
// n <= TWO_PASS_N) or three. Every thread of the block must call it.
template <bool kTwoPass>
__device__ __forceinline__ void tile_dft(float* sr, float* si, const Geom& g,
                                         const float* __restrict__ twr,
                                         const float* __restrict__ twi) {
  if constexpr (kTwoPass) {
    switch (g.log_n) {
      case 1: tile_radix<1>(sr, si, g, twr, twi); break;
      case 2: tile_radix<2>(sr, si, g, twr, twi); break;
      case 3: tile_radix<3>(sr, si, g, twr, twi); break;
      case 4: tile_radix<4>(sr, si, g, twr, twi); break;
      case 5: tile_radix<5>(sr, si, g, twr, twi); break;
      case 6: tile_radix<6>(sr, si, g, twr, twi); break;
      case 7: tile_radix<7>(sr, si, g, twr, twi); break;
      case 8: tile_radix<8>(sr, si, g, twr, twi); break;
      default: break;  // n == 1: the DFT is the identity
    }
  } else {
    switch (g.log_n) {
      case 9: tile_radix3<9>(sr, si, g, twr, twi); break;
      case 10: tile_radix3<10>(sr, si, g, twr, twi); break;
      case 11: tile_radix3<11>(sr, si, g, twr, twi); break;
      case 12: tile_radix3<12>(sr, si, g, twr, twi); break;
      default: break;  // not reached: the launchers pass n <= TILE
    }
  }
}

// K1's three-pass body at n = 2^LOG_N in [512, 4096]: tile_radix3's
// passes on rows [row0, row0 + g.R) of the (rows, n) planes, with no tile
// staged. Pass 1's item (r, i2) loads its 16 points x[row0 + r, i1*B +
// i2] from device memory straight into registers, all 32 loads issued
// before the first is used (rows at or past `rows` read 0); a warp's 32
// consecutive i2 are 128 consecutive bytes of each plane. M1 aliases
// nothing that pass 1 reads, so its store needs no sync before it. Pass 3
// stores each row after its DFT (fewer live registers than all rows at
// once: no spill at 64), applying the epilogue to its registers and
// storing each output straight to y[row0 + r, (o3*16 + o2)*16 + o1]: a
// warp's 16 o1 and two adjacent o2 are 32 consecutive words. Only M1 and
// M2 pass through shared memory, 4 accesses a point and 3 block-wide
// syncs, against tile_radix3's 8 and 7 behind a staged tile; every sum
// and product is tile_radix3's, in its order, so the output is the same
// bits.
template <int LOG_N>
__device__ __forceinline__ void rows_radix3(
    const float* __restrict__ xr, const float* __restrict__ xi,
    float* __restrict__ yr, float* __restrict__ yi, long long rows,
    long long row0, float* sr, float* si, const int R,
    const float* __restrict__ twr, const float* __restrict__ twi,
    const float* __restrict__ er, const float* __restrict__ ei, int period,
    const GTw& gt) {
  constexpr int LOG_C = LOG_N - 2 * LOG_RADIX;
  constexpr int LOG_B = LOG_N - LOG_RADIX;
  constexpr int N = 1 << LOG_N, C = 1 << LOG_C, B = 1 << LOG_B;
  constexpr int RF = P / C;  // rows a full tile holds
  const int t = threadIdx.x;
  float vr[P], vi[P];

  {  // pass 1, from device memory
    const int r = t >> LOG_B, i2 = t & (B - 1);
    const bool on = r < R;
    const bool in = on && row0 + r < rows;
    const long long x = (row0 + r) * N + i2;
#pragma unroll
    for (int i1 = 0; i1 < RADIX; ++i1) {
      vr[i1] = in ? xr[x + i1 * B] : 0.f;
      vi[i1] = in ? xi[x + i1 * B] : 0.f;
    }
    radix3_pass1<LOG_N>(vr, vi, i2, on, twr, twi);
    if (on) radix3_store_m1<LOG_N>(vr, vi, sr, si, r, i2);
    __syncthreads();
  }
  radix3_pass2<LOG_N>(sr, si, R, twr, twi, vr, vi);
  {  // pass 3, each row stored to device memory after its DFT
    const int o1 = t & (RADIX - 1), o2 = t >> LOG_RADIX;
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      radix3_pass3<LOG_N>(sr, si, R, r, twr, twi, vr, vi);
      const long long row = row0 + r;
      if (r < R && row < rows) {
#pragma unroll
        for (int o3 = 0; o3 < C; ++o3) {
          const int o = (o3 * RADIX + o2) * RADIX + o1;
          float ur = vr[r * C + brev(o3, LOG_C)];
          float ui = vi[r * C + brev(o3, LOG_C)];
          rows_epilogue(er, ei, period, gt, row, N, o, ur, ui);
          yr[row * N + o] = ur;
          yi[row * N + o] = ui;
        }
      }
    }
  }
}

// K1: block b transforms rows [b*R, b*R + R) of the (rows, n) planes: at
// n <= 256 (kTwoPass) through a tile staged in shared memory, above it
// with rows_radix3.
template <bool kTwoPass>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            float* __restrict__ yr, float* __restrict__ yi, long long rows,
            Geom g, const float* __restrict__ twr,
            const float* __restrict__ twi, const float* __restrict__ er,
            const float* __restrict__ ei, int period, GTw gt) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + g.plane;
  const long long row0 = (long long)blockIdx.x * g.R;
  if constexpr (kTwoPass) {
    const int tot = g.R * g.n;
    for (int f = threadIdx.x; f < tot; f += NT) {
      const int r = f >> g.log_n, i = f & (g.n - 1);
      const long long row = row0 + r;
      const bool in = row < rows;
      sr[r * g.ld + i] = in ? xr[row * g.n + i] : 0.f;
      si[r * g.ld + i] = in ? xi[row * g.n + i] : 0.f;
    }
    __syncthreads();
    tile_dft<true>(sr, si, g, twr, twi);
    for (int f = threadIdx.x; f < tot; f += NT) {
      const int r = f >> g.log_n, o = f & (g.n - 1);
      const long long row = row0 + r;
      if (row >= rows) continue;
      float vr = sr[r * g.ld + o], vi = si[r * g.ld + o];
      rows_epilogue(er, ei, period, gt, row, g.n, o, vr, vi);
      yr[row * g.n + o] = vr;
      yi[row * g.n + o] = vi;
    }
  } else {
    switch (g.log_n) {
      case 9:
        rows_radix3<9>(xr, xi, yr, yi, rows, row0, sr, si, g.R, twr, twi,
                       er, ei, period, gt);
        break;
      case 10:
        rows_radix3<10>(xr, xi, yr, yi, rows, row0, sr, si, g.R, twr, twi,
                        er, ei, period, gt);
        break;
      case 11:
        rows_radix3<11>(xr, xi, yr, yi, rows, row0, sr, si, g.R, twr, twi,
                        er, ei, period, gt);
        break;
      case 12:
        rows_radix3<12>(xr, xi, yr, yi, rows, row0, sr, si, g.R, twr, twi,
                        er, ei, period, gt);
        break;
      default: break;  // not reached: the launcher passes n <= TILE
    }
  }
}

// K2: block (b, j) transforms columns [c0, c0 + R), c0 = j*R, of the
// slab of nc columns from col0 of matrix b of the (B, L, C) planes: tile j
// of that slab; L = g.n. The (L, R) tile is held transposed, one column a
// shared-memory row at s[r*ld + l].
//   kCluster false (R >= CLUSTER_COLS, or nc < CLUSTER_COLS): the block
//   reads its tile alone, R consecutive floats a matrix row, and stores
//   its own columns.
//   kCluster true: the block is block k = blockIdx.x % K of a cluster of
//   K = 2^log_K blocks, whose G = K*R columns start at cbase = c0 - k*R.
//   It moves rows [k*L/K, (k+1)*L/K) of all G columns on the load, and on
//   a column-major store, through its peers' shared memory (top of file).
//   On the load a thread moves a 4 x 4 block of a plane, 4 rows of 4
//   adjacent columns: one 16-byte global load a row (a warp's: 32 bytes,
//   a whole sector, of each of 16 rows) and one 16-byte remote store a
//   column. On the column-major store it moves one column's 4 rows: one
//   16-byte remote load and 4 single stores (a warp's: 4 rows of G
//   columns, its remote loads spread over all G columns' blocks). Both
//   take L/K >= 4, 16-byte aligned tile rows (ld and plane multiples of
//   4) and 16-byte aligned operand planes: check_cluster refuses a
//   cluster at L < CLUSTER_MIN_N (odd ld) or over unaligned planes.
template <bool kTwoPass, bool kCluster>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
cols_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            float* __restrict__ yr, float* __restrict__ yi, int C, int col0,
            int nc, int tiles_per_b, Geom g, const float* __restrict__ twr,
            const float* __restrict__ twi, const float* __restrict__ er,
            const float* __restrict__ ei, int col_major, GTw gt, int log_K) {
  extern __shared__ __align__(16) float csmem[];
  float* sr = csmem;
  float* si = csmem + g.plane;
  const long long b = blockIdx.x / tiles_per_b;
  const int c0 = (blockIdx.x % tiles_per_b) * g.R;  // within the slab
  const int L = g.n;
  const int tot = g.R * L;
  const long long src = b * L * (long long)C + col0 + c0;
  // the cluster path's block rank k, group of G columns from cbase, first
  // row l0 it moves, and its two planes' shared-window addresses
  const int K = 1 << log_K, log_G = g.log_R + log_K, G = 1 << log_G;
  const int k = blockIdx.x & (K - 1);
  const int cbase = c0 - k * g.R;
  const int l0 = k * (L >> log_K);
  const unsigned ar = kCluster ? smem_addr(sr) : 0u;
  const unsigned ai = kCluster ? smem_addr(si) : 0u;
  if constexpr (!kCluster) {
    for (int f = threadIdx.x; f < tot; f += NT) {
      const int r = f & (g.R - 1), l = f >> g.log_R;
      sr[r * g.ld + l] = xr[src + (long long)l * C + r];
      si[r * g.ld + l] = xi[src + (long long)l * C + r];
    }
    __syncthreads();
  } else {
    const long long gsrc = src - k * g.R;  // column cbase
    // arrives now, waits before the first remote store: every block of
    // the cluster has started, and its shared memory is there
    cluster_arrive_relaxed();
    // a 4 x 4 block: 4 rows of the 4 columns [4h, 4h + 4) of the group
    float ar4[4][4], ai4[4][4];  // [row][column]
    const int h = threadIdx.x & (G / 4 - 1);
    const int l = l0 + ((threadIdx.x >> (log_G - 2)) << 2);
    const bool on = (int)threadIdx.x < (tot >> 4);
    if (on) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long x = gsrc + (long long)(l + i) * C + 4 * h;
        const float4 a = *reinterpret_cast<const float4*>(xr + x);
        const float4 c = *reinterpret_cast<const float4*>(xi + x);
        ar4[i][0] = a.x; ar4[i][1] = a.y; ar4[i][2] = a.z; ar4[i][3] = a.w;
        ai4[i][0] = c.x; ai4[i][1] = c.y; ai4[i][2] = c.z; ai4[i][3] = c.w;
      }
    }
    cluster_wait();
    if (on) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * h + c;
        const unsigned off = 4u * ((j & (g.R - 1)) * g.ld + l);
        const float vr[4] = {ar4[0][c], ar4[1][c], ar4[2][c], ar4[3][c]};
        const float vi[4] = {ai4[0][c], ai4[1][c], ai4[2][c], ai4[3][c]};
        st_peer4(peer_addr(ar + off, j >> g.log_R), vr);
        st_peer4(peer_addr(ai + off, j >> g.log_R), vi);
      }
    }
    cluster_arrive();
    cluster_wait();  // every value of the tile has arrived
  }
  tile_dft<kTwoPass>(sr, si, g, twr, twi);
  if constexpr (kCluster) {
    if (col_major) {  // out[b, o, c], rows [k*L/K, (k+1)*L/K) of G columns
      cluster_arrive();
      cluster_wait();  // every peer's tile is transformed
      // units of one column j and 4 output rows from o: one 16-byte
      // remote load a plane, 4 single stores (a warp's: 4 rows of G
      // columns)
      const int units = tot >> 2;
      float vr[UNITS][4], vi[UNITS][4];
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int p = u * NT + threadIdx.x;
        if (p < units) {
          const int j = p & (G - 1), o = l0 + ((p >> log_G) << 2);
          const unsigned off = 4u * ((j & (g.R - 1)) * g.ld + o);
          ld_peer4(peer_addr(ar + off, j >> g.log_R), vr[u]);
          ld_peer4(peer_addr(ai + off, j >> g.log_R), vi[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int p = u * NT + threadIdx.x;
        if (p < units) {
          const int c = cbase + (p & (G - 1));
          const int o = l0 + ((p >> log_G) << 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cols_epilogue(er, ei, gt, col0 + c, b * nc + c, L, o + i,
                          vr[u][i], vi[u][i]);
            const long long dst = (b * L + o + i) * (long long)nc + c;
            yr[dst] = vr[u][i];
            yi[dst] = vi[u][i];
          }
        }
      }
      cluster_arrive();
      cluster_wait();  // no block leaves while a peer reads its tile
      return;
    }
  }
  for (int f = threadIdx.x; f < tot; f += NT) {
    int r, o;
    long long dst;
    if (col_major) {  // out[b, o, c]
      r = f & (g.R - 1);
      o = f >> g.log_R;
      dst = (b * L + o) * (long long)nc + c0 + r;
    } else {          // out[b*nc + c, o]
      r = f >> g.log_n;
      o = f & (L - 1);
      dst = (b * nc + c0 + r) * (long long)L + o;
    }
    float vr = sr[r * g.ld + o], vi = si[r * g.ld + o];
    cols_epilogue(er, ei, gt, col0 + c0 + r, b * nc + c0 + r, L, o, vr, vi);
    yr[dst] = vr;
    yi[dst] = vi;
  }
}

// The untangle of bin k from Y[k] = (ykr, yki) and its partner P = Y[(m-k)
// % m] = (ypr, ypi): E = (Y[k] + conj(P))/2, O = (Y[k] - conj(P))/2i,
// rounded as the plain version rounds them (untangle_half_spectrum). Both
// of K3's bodies untangle through these two.
struct EO {
  float er, ei, our, oui;
};

__device__ __forceinline__ EO untangle_eo(float ykr, float yki, float ypr,
                                          float ypi) {
  return {__fmul_rn(0.5f, __fadd_rn(ykr, ypr)),
          __fmul_rn(0.5f, __fsub_rn(yki, ypi)),
          __fmul_rn(0.5f, __fadd_rn(yki, ypi)),
          __fmul_rn(0.5f, __fsub_rn(ypr, ykr))};
}

// X[k] = E + v[k] O, v[k] = (wr, wi)
__device__ __forceinline__ void untangle_x(const EO& e, float wr, float wi,
                                           float& xr, float& xi) {
  xr = __fsub_rn(__fadd_rn(e.er, __fmul_rn(wr, e.our)), __fmul_rn(wi, e.oui));
  xi = __fadd_rn(__fadd_rn(e.ei, __fmul_rn(wr, e.oui)), __fmul_rn(wi, e.our));
}

// K3's three-pass body at m = 2^LOG_N in [512, 4096]: tile_radix3's
// passes on real rows [row0, row0 + R) of x, packed as m complex points
// each, with no tile staged, as rows_radix3 runs them for K1. Pass 1's
// item (r, i2) loads its 16 packed points x[row0 + r, i1*B + i2] (one
// float2 each, all 16 issued before the first is used; rows at or past
// `rows` read 0) from device memory straight into registers; a warp's 32
// consecutive i2 are 256 consecutive bytes. M1 aliases nothing that pass
// 1 reads, so its store needs no sync before it.
//   untangle == 0: pass 3 stores each row after its DFT straight to y[row0
//   + r, o], as rows_radix3 does: 4 shared-memory accesses a point.
//   untangle != 0: Y[k] and its partner Y[(m-k) % m] lie in other
//   threads' registers, so pass 3 writes the row's spectrum Y once to
//   r*m + o over M2 (after a sync), and each thread then takes pairs (k,
//   m-k), 0 < k < m/2: it reads the pair's four words once and writes
//   X[k] and X[m-k]; the pair (0, 0) gives X[0] and the Nyquist X[m], and
//   its thread also writes X[m/2] from Y[m/2]. 6 shared-memory accesses a
//   point and 5 block-wide syncs, against 9 and 7 behind a staged tile.
// The rows and pairs come from two loops, not from a division by the row
// width m+1. Every sum and product is tile_radix3's and the staged
// untangle's, on the same words in the same order, so the output is the
// same bits.
template <int LOG_N>
__device__ __forceinline__ void rfft_radix3(
    const float2* __restrict__ x, float* __restrict__ yr,
    float* __restrict__ yi, long long rows, long long row0, float* sr,
    float* si, const int R, const float* __restrict__ twr,
    const float* __restrict__ twi, const float* __restrict__ pwr,
    const float* __restrict__ pwi, int untangle) {
  constexpr int LOG_C = LOG_N - 2 * LOG_RADIX;
  constexpr int LOG_B = LOG_N - LOG_RADIX;
  constexpr int M = 1 << LOG_N, C = 1 << LOG_C, B = 1 << LOG_B;
  constexpr int RF = P / C;  // rows a full tile holds
  const int t = threadIdx.x;
  const int o1 = t & (RADIX - 1), o2 = t >> LOG_RADIX;
  float vr[P], vi[P];

  {  // pass 1, from device memory
    const int r = t >> LOG_B, i2 = t & (B - 1);
    const bool on = r < R;
    const bool in = on && row0 + r < rows;
    const long long xo = (row0 + r) * M + i2;
#pragma unroll
    for (int i1 = 0; i1 < RADIX; ++i1) {
      const float2 z = in ? x[xo + i1 * B] : make_float2(0.f, 0.f);
      vr[i1] = z.x;
      vi[i1] = z.y;
    }
    radix3_pass1<LOG_N>(vr, vi, i2, on, twr, twi);
    if (on) radix3_store_m1<LOG_N>(vr, vi, sr, si, r, i2);
    __syncthreads();
  }
  radix3_pass2<LOG_N>(sr, si, R, twr, twi, vr, vi);
  if (!untangle) {  // pass 3, each row stored to device memory after its DFT
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      radix3_pass3<LOG_N>(sr, si, R, r, twr, twi, vr, vi);
      const long long row = row0 + r;
      if (r < R && row < rows) {
#pragma unroll
        for (int o3 = 0; o3 < C; ++o3) {
          const int o = (o3 * RADIX + o2) * RADIX + o1;
          yr[row * M + o] = vr[r * C + brev(o3, LOG_C)];
          yi[row * M + o] = vi[r * C + brev(o3, LOG_C)];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < RF; ++r)
    radix3_pass3<LOG_N>(sr, si, R, r, twr, twi, vr, vi);
  __syncthreads();  // Y overwrites M2
#pragma unroll
  for (int r = 0; r < RF; ++r) {
    if (r < R) {
#pragma unroll
      for (int o3 = 0; o3 < C; ++o3) {
        const int o = r * M + (o3 * RADIX + o2) * RADIX + o1;
        sr[o] = vr[r * C + brev(o3, LOG_C)];
        si[o] = vi[r * C + brev(o3, LOG_C)];
      }
    }
  }
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + r;
    if (row >= rows) break;
    const float* ar = sr + r * M;
    const float* ai = si + r * M;
    float* xr = yr + row * (M + 1);
    float* xi = yi + row * (M + 1);
#pragma unroll
    for (int k = t; k < M / 2; k += NT) {
      const int p = (M - k) & (M - 1);
      const float ykr = ar[k], yki = ai[k], ypr = ar[p], ypi = ai[p];
      const EO e = untangle_eo(ykr, yki, ypr, ypi);
      untangle_x(e, __ldg(pwr + k), __ldg(pwi + k), xr[k], xi[k]);
      if (k) {
        untangle_x(untangle_eo(ypr, ypi, ykr, yki), __ldg(pwr + p),
                   __ldg(pwi + p), xr[p], xi[p]);
      } else {  // Nyquist X[m] = E[0] - O[0], real; and X[m/2]
        xr[M] = __fsub_rn(e.er, e.our);
        xi[M] = 0.f;
        const int h = M / 2;
        untangle_x(untangle_eo(ar[h], ai[h], ar[h], ai[h]), __ldg(pwr + h),
                   __ldg(pwi + h), xr[h], xi[h]);
      }
    }
  }
}

// K3: block b transforms real rows [b*R, b*R + R) of x (rows, 2m), packed
// as m complex points each; g.n = m. untangle != 0 writes the one-sided
// (rows, m+1) spectrum (untangle_half_spectrum, rounded as the plain
// version rounds it), untangle == 0 the packed (rows, m) half spectrum.
// At m <= 256 (kTwoPass) through a tile staged in shared memory and an
// untangle in the store loop, above it with rfft_radix3.
template <bool kTwoPass>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
rfft_kernel(const float2* __restrict__ x, float* __restrict__ yr,
            float* __restrict__ yi, long long rows, Geom g,
            const float* __restrict__ twr, const float* __restrict__ twi,
            const float* __restrict__ vr, const float* __restrict__ vi,
            int untangle) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + g.plane;
  const long long row0 = (long long)blockIdx.x * g.R;
  if constexpr (kTwoPass) {
    const int m = g.n;
    const int tot = g.R * m;
    for (int f = threadIdx.x; f < tot; f += NT) {
      const int r = f >> g.log_n, k = f & (m - 1);
      const long long row = row0 + r;
      const float2 z = row < rows ? x[row * m + k] : make_float2(0.f, 0.f);
      sr[r * g.ld + k] = z.x;
      si[r * g.ld + k] = z.y;
    }
    __syncthreads();
    tile_dft<true>(sr, si, g, twr, twi);
    const int w = untangle ? m + 1 : m;
    for (int f = threadIdx.x; f < g.R * w; f += NT) {
      const int r = f / w, k = f - r * w;
      const long long row = row0 + r;
      if (row >= rows) continue;
      const float* ar = sr + r * g.ld;
      const float* ai = si + r * g.ld;
      float xr, xi;
      if (!untangle) {
        xr = ar[k];
        xi = ai[k];
      } else {
        const int kk = k < m ? k : 0;
        const int p = (m - kk) & (m - 1);
        const EO e = untangle_eo(ar[kk], ai[kk], ar[p], ai[p]);
        if (k < m) {
          untangle_x(e, __ldg(vr + k), __ldg(vi + k), xr, xi);
        } else {  // Nyquist X[m] = E[0] - O[0], real
          xr = __fsub_rn(e.er, e.our);
          xi = 0.f;
        }
      }
      yr[row * w + k] = xr;
      yi[row * w + k] = xi;
    }
  } else {
    switch (g.log_n) {
      case 9:
        rfft_radix3<9>(x, yr, yi, rows, row0, sr, si, g.R, twr, twi, vr, vi,
                       untangle);
        break;
      case 10:
        rfft_radix3<10>(x, yr, yi, rows, row0, sr, si, g.R, twr, twi, vr, vi,
                        untangle);
        break;
      case 11:
        rfft_radix3<11>(x, yr, yi, rows, row0, sr, si, g.R, twr, twi, vr, vi,
                        untangle);
        break;
      case 12:
        rfft_radix3<12>(x, yr, yi, rows, row0, sr, si, g.R, twr, twi, vr, vi,
                        untangle);
        break;
      default: break;  // not reached: the launcher passes m <= TILE
    }
  }
}

int log2i(int v) {
  int p = 0;
  while ((1 << p) < v) ++p;
  return p;
}

// The shared-memory row stride ld, in floats, the plane size and the
// two-pass branch's warp shape.
// Two passes (n <= 256): room for the intermediate (i2 at stride RADIX +
// 1), 17b - 1 floats for n = 16b >= 32, and n below.
//   K1, K3 (no pad): ld is the least odd multiple of b (b = 1 for n <= 16):
//   17b for n >= 32, n + 1 below. A warp of either pass takes w = b
//   adjacent columns of 32 / b rows, and each access of both passes —
//   x at r*ld + i1*b + i2, the intermediate at r*ld + i2*(RADIX+1) + o1,
//   y at r*ld + o2*RADIX + o1 — falls in 32 different banks: the warp's w
//   columns differ mod w (RADIX + 1 is odd) and its rows lie at distinct
//   multiples of w mod 32 (ld / w is odd).
//   K2 (pad): the transposing load's rule below fixes ld % 32; the passes
//   then take w = the largest power of two dividing ld (at most b),
//   conflict-free by the same argument whenever R * w >= 32.
// Three passes (n >= 512, b = n / 16 >= 32, c = b / 16): a warp is 32
// consecutive threads, and no access leans on rows or on ld, so the
// argument holds at R = 1 (n = 4096, where a warp spans part of one row)
// and for K2's ld alike. At each unrolled step:
//   pass 1 reads x at r*ld + i1*b + i2 and stores M1 at (r*16 + o1)*(b +
//   2) + i2 for 32 consecutive i2 of one row: 32 consecutive words;
//   pass 2 reads M1 for 16 o1 and two adjacent i2b of one row: banks
//   2*o1 + i2b + const (b + 2 = 2 mod 32), 32 different; it stores M2 at
//   d*272 + o2*16 + o1 for 16 o1 and two adjacent d: banks 16*d + o1 +
//   const (272 = 16 mod 32), 32 different;
//   pass 3 reads M2 and stores y at r*ld + (o3*16 + o2)*16 + o1 for 16 o1
//   and two adjacent o2: 32 consecutive words.
//   K1 and K3 make pass 1's reads and pass 3's stores on device memory at
//   the same offsets of row row0 + r (128 coalesced bytes a warp of each
//   plane; K3's float2 reads 256), and use only the intermediates of the
//   plane; K3's untangle writes Y at r*ld + o over M2, as the staged tile
//   was, and reads Y[k] and Y[m-k] for 32 consecutive k: 32 different
//   banks each.
//   K1, K3: ld = n. K2: ld from the load's rule. The plane holds the rows
//   and both intermediates: max(R*ld, 16R*(b + 2), (R*c - 1)*272 + 256)
//   floats, 4336-4352 for a full tile (34-35 KB a block for both planes),
//   the intermediates' size alone at every tile.
Geom make_geom(int n, int R, bool pad) {
  Geom g;
  g.n = n;
  g.log_n = log2i(n);
  g.R = R;
  g.log_R = log2i(R);
  const bool two_pass = n <= TWO_PASS_N;
  const int b = n > RADIX ? n / RADIX : 1;
  const int base = !two_pass ? n : (b > 1 ? (RADIX + 1) * b - 1 : n);
  int ld = base;
  if (pad) {
    // K2's transposed tile accesses, ld % 32 == 32 / R (odd when R >=
    // 32). One block (R >= 8, or slabs of fewer than 8 columns): a warp
    // writes R columns x 32/R rows of the tile, words r*ld + l with banks
    // r*(32/R) + l mod 32, 32 different. A cluster (R < G = 8, cols_kernel
    // says which accesses): an 8-thread phase of the load's 16-byte
    // remote stores gives each peer 4 runs of 4 words of one tile row,
    // 16 consecutive words, at any ld; one of the column-major store's
    // 16-byte remote loads gives each peer R columns x 4 words, banks
    // r*(32/R) + o .. o + 3, r < R: different since 32/R >= 4. So the
    // rule the one-block load needs is the rule the cluster needs too,
    // and the two paths share one geometry. From n = 32 on, R < 8 gives
    // ld a multiple of 8: the cluster's 16-byte accesses are aligned.
    if (base < 32) {
      ld = base | 1;
    } else {
      const int target = R < 32 ? 32 / R : 1;
      ld = base + (((target - base) % 32) + 32) % 32;
    }
  } else if (two_pass) {
    ld = (base + b - 1) / b * b;
    if (!((ld / b) & 1)) ld += b;
  }
  g.ld = ld;
  g.plane = R * ld;
  if (!two_pass) {
    const int m1 = RADIX * R * (b + M1_PAD);
    const int m2 = (R * (b / RADIX) - 1) * M2_STRIDE + TWO_PASS_N;
    if (m1 > g.plane) g.plane = m1;
    if (m2 > g.plane) g.plane = m2;
  }
  g.log_w = 0;
  while (g.log_w < LOG_RADIX && !(ld & (1 << g.log_w))) ++g.log_w;
  return g;
}

int smem_bytes(const Geom& g) { return 2 * g.plane * (int)sizeof(float); }

// The global twiddle's kernel argument; 0 on success, else the error of a
// bad N (a power of two up to 2^32 wanted).
int make_gtw(const float* hr, const float* hi, const float* lr,
             const float* li, long long n_global, long long row_off,
             GTw& t) {
  t = GTw{hr, hi, lr, li, (unsigned long long)row_off, 0u, 0};
  if (hr == nullptr) return 0;
  if (n_global < 1 || n_global > (1ll << 32) || (n_global & (n_global - 1))
      || row_off < 0)
    return (int)cudaErrorInvalidValue;
  int p = 0;
  while ((1ll << p) < n_global) ++p;
  t.mask = (unsigned)(n_global - 1);
  t.k = (p + 1) / 2;
  return 0;
}

// Launches one instantiation of a kernel with the tile's shared memory;
// cluster > 1: as thread-block clusters of that many blocks along x
// (cudaLaunchKernelEx; blocks a multiple of it). A launch the card
// refuses returns its error; nothing is retried another way.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long blocks, const Geom& g,
           void* stream, int cluster, Args... args) {
  const int smem = smem_bytes(g);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MAX_SMEM);
  if (cluster == 1) {
    kernel<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller reports it
    return (int)rc;
  }
  return (int)cudaGetLastError();
}

// 0 if K2's cluster (R, K) at length L over a slab of nc columns is one
// the kernel takes (kernels/fft/plan.py:check_col_cluster mirrors it): K
// = 1, or K a power of two <= MAX_CLUSTER with K * R = CLUSTER_COLS, nc /
// R a multiple of K, L >= CLUSTER_MIN_N and both planes 16-byte aligned;
// R a power of two dividing nc.
int check_cluster(int L, int R, int nc, int K, const float* xr,
                  const float* xi) {
  if (R < 1 || (R & (R - 1)) || nc % R) return (int)cudaErrorInvalidValue;
  if (K == 1) return 0;
  if (K < 1 || K > MAX_CLUSTER || (K & (K - 1)) || K * R != CLUSTER_COLS ||
      (nc / R) % K || L < CLUSTER_MIN_N || (((size_t)xr | (size_t)xi) & 15))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Returns 0, or the CUDA error code of the launch. wr, wi: the leaf table
// W_n^k (n,). er, ei: the periodic epilogue table or null; ghr .. gli:
// the global twiddle's tables (kernels/fft/plan.py:global_twiddles) or
// null, with n_global and the logical row of row 0, row_off.
int matfft_rows(const float* xr, const float* xi, float* yr, float* yi,
                long long rows, int n, const float* wr, const float* wi,
                const float* er, const float* ei, int period,
                const float* ghr, const float* ghi, const float* glr,
                const float* gli, long long n_global, long long row_off,
                void* stream) {
  if (n < 1 || n > TILE || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  GTw gt;
  if (const int rc = make_gtw(ghr, ghi, glr, gli, n_global, row_off, gt))
    return rc;
  const Geom g = make_geom(n, TILE / n, false);
  const long long blocks = (rows + g.R - 1) / g.R;
  if (blocks == 0) return 0;
  return launch(n <= TWO_PASS_N ? rows_kernel<true> : rows_kernel<false>,
                blocks, g, stream, 1, xr, xi, yr, yi, rows, g, wr, wi, er,
                ei, period, gt);
}

// The slab [col0, col0 + nc) of the C columns: nc a power of two, col0 a
// multiple of it; the output is (B, L, nc) col-major or (B * nc, L).
// cluster: the blocks of a thread-block cluster (kernels/fft/plan.py:col_cluster; 1: one block
// alone), checked by check_cluster.
int matfft_cols(const float* xr, const float* xi, float* yr, float* yi,
                long long B, int L, int C, int col0, int nc, const float* wr,
                const float* wi, const float* er, const float* ei,
                int col_major, const float* ghr, const float* ghi,
                const float* glr, const float* gli, long long n_global,
                long long row_off, int cluster, void* stream) {
  if (L < 1 || L > TILE || (L & (L - 1)) || C < 1 || (C & (C - 1)) ||
      nc < 1 || (nc & (nc - 1)) || col0 < 0 || col0 % nc || col0 + nc > C)
    return (int)cudaErrorInvalidValue;
  GTw gt;
  if (const int rc = make_gtw(ghr, ghi, glr, gli, n_global, row_off, gt))
    return rc;
  const int R = TILE / L < nc ? TILE / L : nc;
  if (const int rc = check_cluster(L, R, nc, cluster, xr, xi)) return rc;
  const Geom g = make_geom(L, R, true);
  const int tiles_per_b = nc / R;
  const long long blocks = B * tiles_per_b;
  if (blocks == 0) return 0;
  const bool two = L <= TWO_PASS_N;
  if (cluster == 1)
    return launch(two ? cols_kernel<true, false> : cols_kernel<false, false>,
                  blocks, g, stream, 1, xr, xi, yr, yi, C, col0, nc,
                  tiles_per_b, g, wr, wi, er, ei, col_major, gt, 0);
  // a cluster forms only at L >= 1024 (check_cluster refuses one below)
  return launch(cols_kernel<false, true>, blocks, g, stream, cluster, xr, xi,
                yr, yi, C, col0, nc, tiles_per_b, g, wr, wi, er, ei,
                col_major, gt, log2i(cluster));
}

// The clusters of K2's cluster path that can be resident on the card at
// once (cudaOccupancyMaxActiveClusters) at length L, K blocks a cluster;
// or minus the CUDA error. L <= TWO_PASS_N is refused: a block holds at
// least CLUSTER_COLS columns there, and no cluster forms.
int matfft_cols_clusters(int L, int cluster) {
  if (L <= TWO_PASS_N || L > TILE || (L & (L - 1)) || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
    return -(int)cudaErrorInvalidValue;
  const Geom g = make_geom(L, TILE / L, true);
  auto kernel = cols_kernel<false, true>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MAX_SMEM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes(g);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t rc =
      cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return rc == cudaSuccess ? n : -(int)rc;
}

// x: real (rows, 2m), 8-byte aligned; yr, yi: (rows, m+1) with untangle,
// (rows, m) without; wr, wi: the leaf table at length m; vr, vi: the
// packing twiddle W_{2m}^k (m,).
int matfft_rfft(const float* x, float* yr, float* yi, long long rows, int m,
                const float* wr, const float* wi, const float* vr,
                const float* vi, int untangle, void* stream) {
  if (m < 2 || m > TILE || (m & (m - 1)) || ((size_t)x & 7))
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(m, TILE / m, false);
  const long long blocks = (rows + g.R - 1) / g.R;
  if (blocks == 0) return 0;
  return launch(m <= TWO_PASS_N ? rfft_kernel<true> : rfft_kernel<false>,
                blocks, g, stream, 1, reinterpret_cast<const float2*>(x), yr,
                yi, rows, g, wr, wi, vr, vi, untangle);
}

}  // extern "C"
