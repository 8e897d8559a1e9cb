// Hand-written Hopper kernel for the radix-2 Stockham FFT (K4).
//
//   stockham_rows  forward DFT along the last axis of planar (rows, n) f32,
//                  n a power of two, 2 <= n <= 4096, natural-order output.
//                  Replaces repro/kernels/fft/stockham.py:stockham_fft
//                  (Pallas body _stockham_kernel).
//
// The transform is the reference's: log2 n decimation-in-frequency radix-2
// stages. Stage s has l = n >> (s+1) twiddles at offset off_s = n - 2l of
// the packed table (kernels/fft/plan.py:stockham_twiddles) and sub-length
// ms = 2^s. Viewing a row as x[h, j, k] at h*l*ms + j*ms + k, each
// butterfly
//     y[j, 0, k] = a + b,   y[j, 1, k] = (a - b) * w[off_s + j]
// with a = x[0, j, k], b = x[1, j, k], writes y[j, t, k] at j*2ms + t*ms
// + k. The twiddles are the plan's float32 table (no sin/cos on the card),
// and every sum and product is rounded as the plain PyTorch version
// (kernels/fft/matfft.py:stockham_stages) rounds it (__fadd_rn,
// __fmul_rn: no contraction), so the kernel equals it bit for bit. In the
// last group the products with w_0 = 1 are skipped, which changes at most
// the sign of a zero.
//
// What bounds it on an H100: 16 bytes of device memory traffic a point
// against 5 log2 n / 2 flops a point, so at n = 1024 about 1.6 flops a
// byte, far below the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20):
// it is bound by bytes. The design touches device memory once a point each
// way, coalesced, and keeps the stages in registers.
//
// Groups of stages. The stages run in groups of up to four, short group
// last (n = 1024: 4 + 4 + 2), each group in the registers of one thread.
// A group starts at stage s, runs g stages, Q = 2^g, ms = 2^s, J = n /
// (ms Q). Its item (r, j, k), j < J, k < ms, holds the Q points
//     v[q] = x[r, (j + q J) ms + k],   q < Q      (row r as (Q, J, ms))
// and runs the g stages in place: stage t pairs registers i and i + h, h =
// Q >> (t+1), inside each block of 2h registers, with twiddle entry
// off_{s+t} + j + i J of the table, which is the butterfly j' = i J + j of
// stage s + t in the view above. Register rho then holds output c =
// brev_g(rho) of the item, which goes to
//     y[r, (j Q + c) ms + k]                      (row r as (J, Q, ms)),
// the data of stage s + g. This is the radix leaf's reg_dft
// (csrc/matfft.cu) with the stage's own twiddles. The first group has ms =
// 1, so it reads rows from device memory straight into registers (for a
// fixed q, a warp's consecutive j are consecutive words); the last has J =
// 1, so it stores straight to device memory (consecutive k are consecutive
// words). Only the exchanges between groups pass through shared memory:
// none for n <= 16, one for n <= 256, two above, each a store and a load
// of every point (4 accesses a point and 3 block-wide syncs at n = 1024,
// against 22 and 21 for one stage at a time). The short group goes last:
// every other group is then a full 16-point group, one item a thread, and
// the short one, where a thread holds 16 / Q items, has J = 1, so its
// twiddles are the same for every item and known to be 1 at i = 0.
//
// Banks. A block holds R = 4096 / n whole rows, tile offset f = r n + idx,
// one 16 KB plane each for the real and imaginary parts. Every exchange
// stores and loads element f at
//     swz(f) = (f & ~31) | (par(f >> 4 & 31) << 4) | ((f ^ f >> 5) & 15),
// par = parity: the tile as 256 lines of 16 words, line lam = f >> 4 in
// the 32-word chunk lam >> 1, its words XORed with lam >> 1 & 15 and its
// half of the chunk chosen by the parity of lam's low 5 bits. A bijection
// within each chunk. Bank = 16 par(lam & 31) + (c ^ (lam >> 1 & 15)), c =
// f & 15. In every exchange a warp's 32 accesses are one of:
//   (a) one word c of 32 consecutive lines, 32-aligned: the first group's
//       store (16 j + c for 32 consecutive j of one row, or 32 / J rows x
//       J j at n < 512; either way 32 consecutive lam). The pair (par, lam
//       >> 1 & 15) takes all 32 values over lam's low 5 bits.
//   (b) all 16 words of two lines that differ in one of lam's bits 1-4:
//       the middle group's store at n >= 512 (lines of j and j + 1 for
//       even j, 256/16 = 16 apart), the last group's load at n <= 256 (two
//       rows r, r + 1 for even r: lines r J + q and that + J, J = n / 16 in
//       2..16). The parities differ, so the two lines fill the two halves.
//   (c) one aligned 32-word chunk: the middle group's load ((j + q J) 16 +
//       k for an even and odd j, J even) and the last group's at n >= 512
//       (q 256 + k, 32 consecutive k). The XOR is constant on a chunk.
// No access has a bank conflict, at every R down to 1, where a warp lies
// inside one row.
//
// The tile is fixed at R = 4096 / n rows a block: a block keeps its 256
// threads whatever it stages, so a narrower tile only leaves threads idle
// and fits no more blocks on a SM.
//
// A row's result depends only on its own values, so it is the same
// whatever the batch size or the row's place in it. Each instantiation is
// held to 64 registers (four blocks of 256 threads a SM); the register
// arrays are indexed only by constants after unrolling.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int P = 16;              // points a thread holds
constexpr int TILE = NT * P;       // complex points per block
constexpr int MAX_G = 4;           // stages a group

// Bit reversal of the low `bits` bits of v, bits <= 4. No loop, so that it
// folds to a constant wherever v and bits are.
__device__ __forceinline__ constexpr int brev(int v, int bits) {
  return (((v & 1) << 3) | ((v & 2) << 1) | ((v & 4) >> 1) |
          ((v & 8) >> 3)) >> (MAX_G - bits);
}

// The shared-memory word of tile offset f (the bank argument above).
__device__ __forceinline__ int swz(int f) {
  return (f & ~31) | ((__popc((f >> 4) & 31) & 1) << 4) |
         ((f ^ (f >> 5)) & 15);
}

// The G stages of the group that starts at stage S, in place on the Q =
// 2^G registers v[off, off + Q) of item j (off a constant after
// unrolling): stage t pairs v[i] and v[i + h], h = Q >> (t+1), in each
// block of 2h, with twiddle entry off_{S+t} + j + i J.
template <int LOG_N, int S, int G>
__device__ __forceinline__ void group_stages(float (&vr)[P], float (&vi)[P],
                                             const int off, const int j,
                                             const float* __restrict__ twr,
                                             const float* __restrict__ twi) {
  constexpr int N = 1 << LOG_N;
  constexpr int Q = 1 << G;
  constexpr int J = N >> (S + G);
#pragma unroll
  for (int t = 0; t < G; ++t) {
    const int h = Q >> (t + 1);
    const int toff = N - (N >> (S + t)) + j;  // off_{S+t} + j
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const bool one = J == 1 && i == 0;  // w_0 = 1: skip its product
      const float wr = one ? 1.f : __ldg(twr + toff + i * J);
      const float wi = one ? 0.f : __ldg(twi + toff + i * J);
#pragma unroll
      for (int blk = 0; blk < Q; blk += 2 * h) {
        const int ia = off + blk + i, ib = ia + h;
        const float ar = vr[ia], ai = vi[ia], br = vr[ib], bi = vi[ib];
        vr[ia] = __fadd_rn(ar, br);
        vi[ia] = __fadd_rn(ai, bi);
        const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
        if (one) {
          vr[ib] = dr;
          vi[ib] = di;
        } else {
          vr[ib] = __fsub_rn(__fmul_rn(wr, dr), __fmul_rn(wi, di));
          vi[ib] = __fadd_rn(__fmul_rn(wr, di), __fmul_rn(wi, dr));
        }
      }
    }
  }
}

// One group: load each item's Q points (from the rows in device memory if
// S == 0, else from the tile in shared memory), run its stages, store its
// outputs (to device memory if it is the last group, else to the tile).
// Item u of thread t is p = u * NT + t, split (r, j, k) with k fastest.
template <int LOG_N, int S>
__device__ __forceinline__ void group(const float* __restrict__ xr,
                                      const float* __restrict__ xi,
                                      float* __restrict__ yr,
                                      float* __restrict__ yi, int rows_here,
                                      float* sr, float* si,
                                      const float* __restrict__ twr,
                                      const float* __restrict__ twi) {
  constexpr int G = LOG_N - S < MAX_G ? LOG_N - S : MAX_G;
  constexpr bool FIRST = S == 0, LAST = S + G == LOG_N;
  constexpr int N = 1 << LOG_N, Q = 1 << G, MS = 1 << S;
  constexpr int LOG_J = LOG_N - S - G, J = 1 << LOG_J;
  constexpr int U = P / Q;  // items a thread
  float vr[P], vi[P];
  int row[U], jj[U], kk[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int p = u * NT + threadIdx.x;
    kk[u] = p & (MS - 1);
    jj[u] = (p >> S) & (J - 1);
    row[u] = p >> (LOG_N - G);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int in = row[u] * N + jj[u] * MS + kk[u];  // + q J MS
    const bool live = row[u] < rows_here;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int f = in + q * J * MS;
      if constexpr (FIRST) {
        vr[u * Q + q] = live ? xr[f] : 0.f;
        vi[u * Q + q] = live ? xi[f] : 0.f;
      } else {
        vr[u * Q + q] = sr[swz(f)];
        vi[u * Q + q] = si[swz(f)];
      }
    }
  }
  // every load done before the tile is reused
  if constexpr (!FIRST) __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u)
    group_stages<LOG_N, S, G>(vr, vi, u * Q, jj[u], twr, twi);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int out = row[u] * N + jj[u] * Q * MS + kk[u];  // + c MS
    const bool live = row[u] < rows_here;
#pragma unroll
    for (int rho = 0; rho < Q; ++rho) {
      const int f = out + brev(rho, G) * MS;
      if constexpr (LAST) {
        if (live) {
          yr[f] = vr[u * Q + rho];
          yi[f] = vi[u * Q + rho];
        }
      } else {
        sr[swz(f)] = vr[u * Q + rho];
        si[swz(f)] = vi[u * Q + rho];
      }
    }
  }
  // every store done before the next group loads
  if constexpr (!LAST) __syncthreads();
}

// Block b transforms rows [b*R, b*R + R), R = TILE >> LOG_N (`launch`):
// the last block's rows at or past `rows` are dead (no load, no store),
// so every row is computed as in a full block.
template <int LOG_N>
__global__ void __launch_bounds__(NT, 4)
stockham_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                long long rows, int R, const float* __restrict__ twr,
                const float* __restrict__ twi) {
  __shared__ float sr[LOG_N > MAX_G ? TILE : 1];
  __shared__ float si[LOG_N > MAX_G ? TILE : 1];
  const long long row0 = (long long)blockIdx.x * R;
  const long long left = rows - row0;
  const int rows_here = left < R ? (int)left : R;
  const long long base = row0 << LOG_N;
  xr += base;
  xi += base;
  yr += base;
  yi += base;
  group<LOG_N, 0>(xr, xi, yr, yi, rows_here, sr, si, twr, twi);
  if constexpr (LOG_N > MAX_G)
    group<LOG_N, MAX_G>(xr, xi, yr, yi, rows_here, sr, si, twr, twi);
  if constexpr (LOG_N > 2 * MAX_G)
    group<LOG_N, 2 * MAX_G>(xr, xi, yr, yi, rows_here, sr, si, twr, twi);
}

template <int LOG_N>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           long long rows, const float* twr, const float* twi,
           void* stream) {
  constexpr int R = TILE >> LOG_N;
  const long long blocks = (rows + R - 1) / R;
  if (blocks == 0) return 0;
  stockham_kernel<LOG_N><<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, rows, R, twr, twi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0, or the CUDA error code of the launch. tw_r, tw_i: the packed
// (n,) per-stage twiddle table of plan.stockham_twiddles(n).
int stockham_rows(const float* xr, const float* xi, float* yr, float* yi,
                  long long rows, int n, const float* tw_r,
                  const float* tw_i, void* stream) {
  switch (n) {
#define STOCKHAM_CASE(LOG_N)                                               \
  case 1 << LOG_N:                                                         \
    return launch<LOG_N>(xr, xi, yr, yi, rows, tw_r, tw_i, stream);
    STOCKHAM_CASE(1) STOCKHAM_CASE(2) STOCKHAM_CASE(3) STOCKHAM_CASE(4)
    STOCKHAM_CASE(5) STOCKHAM_CASE(6) STOCKHAM_CASE(7) STOCKHAM_CASE(8)
    STOCKHAM_CASE(9) STOCKHAM_CASE(10) STOCKHAM_CASE(11) STOCKHAM_CASE(12)
#undef STOCKHAM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
