// Hand-written Hopper kernels for the leaf transforms.
//
//   matfft_rows   K1: DFT along the last axis of planar (rows, n) f32.
//                 Replaces repro/kernels/fft/matfft.py:matfft (Pallas bodies
//                 _dft_kernel and _matfft_kernel).
//   matfft_cols   K2: DFT along the MIDDLE axis of planar (B, L, C) f32,
//                 stored row-major (B*C, L) or column-major (B, L, C).
//                 Replaces repro/kernels/fft/matfft.py:matfft_cols (Pallas
//                 body _col_kernel).
//
// All three run one tile algebra (tile_dft below): a block stages TILE =
// 4096 complex points in shared memory (R = TILE / n whole rows, or R
// columns of one (L, C) matrix for K2), in natural order, transforms them
// in place, and stores them with the optional epilogue (K1, K2) or the
// untangle (K3) fused into the store. Each kernel has two instantiations,
// one for each branch of the tile algebra, so that each gets the registers
// its own branch needs: the radix one is held to 64 registers a thread, so
// that four blocks (1024 threads, 34-50 KB of shared memory each) fit a
// SM.
//
//   n <= 256   radix FFT (tile_radix), n = a * b, a = min(n, RADIX = 16),
//              i = i1*b + i2, o = o2*a + o1:
//                A[o1, i2] = W_n^{i2*o1} * DFT_a(x[. * b + i2])[o1]
//                y[o2*a + o1] = DFT_b(A[o1, .])[o2]
//              Each DFT runs in one thread's registers: the radix-2
//              butterflies of the plain version's Stockham stages, kept in
//              place (reg_dft). The reference's direct DFT (one product
//              with the (n, n) DFT matrix) is replaced, not ported.
//   n  > 256   four-step with n = n1 * n2 (i = i1*n2 + i2, o = o2*n1 + o1):
//                B[o1, i2] = T[o1, i2] * sum_i1 x[i1*n2 + i2] W1[i1, o1]
//                y[o2*n1 + o1] = sum_i2 B[o1, i2] W2[i2, o2]
//
// The tables (the radix branch's (n,) roots of unity W_n^k; the four-step's
// W1, W2 and T) are the plan's float32 tables, computed in float64 on the
// host (kernels/fft/plan.py) and read through the read-only cache; no
// sin/cos is evaluated on the card.
//
// What bounds it on an H100. The radix branch does about 34 flops a point
// at n = 256 (two 16-point passes of 32 butterflies and 17 twiddle
// products each, and the inner twiddle) against 16 bytes of device memory
// traffic, about 2 flops a byte, far below the card's f32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20): it is bound by bytes. The design reads
// and writes device memory once a point each way, coalesced, and keeps
// shared memory to two round trips a pass: each of 256 threads reads its
// 16 points into registers, runs its DFTs there, and writes back once,
// through strides chosen so that no access has a bank conflict (make_geom
// says how). The four-step branch issues 4*n*(n1+n2) real FMAs per row
// against the same 16*n bytes, so it is bound by f32 FMA issue and by
// shared-memory operand reads; it keeps every intermediate in shared
// memory, holds each thread's 16 outputs in registers so the in-place
// update needs no second buffer, and lays the intermediate out so that
// each warp reads consecutive shared-memory words and one table entry (a
// broadcast). Both use IEEE f32 on the CUDA cores: no TF32 and no tensor
// cores; the radix branch rounds every product and sum as its plain
// PyTorch version does (__fmul_rn, __fadd_rn: no contraction).
//
//   matfft_rfft   K3: one-sided spectrum of real (rows, n) f32, n = 2m.
//                 Replaces repro/kernels/fft/matfft.py:_rfft_pallas (Pallas
//                 body _rfft_kernel, fused untangle_half_spectrum), behind
//                 rfft_leaf and rfft_pack_leaf.
//
// K3 packs z[k] = x[2k] + i x[2k+1] as it loads (one 8-byte float2 read
// per complex point, so the packing costs nothing), runs tile_dft at the
// half length m with R = TILE / m whole rows a block, and untangles in
// the store loop: Y[k] and its partner Y[(m-k) % m] are in the same
// shared-memory row, v[k] = W_n^k comes from the plan's rfft_twiddle
// table. It reads 4n bytes and writes 8(m+1) a row, half the traffic and
// about half the work of the complex transform of the same row. The
// output row stride m+1 is odd, so its stores are scalar.
//
// A row's result depends only on its own values: every output is a fixed
// sequence of operations on its own row, with no reduction across rows,
// so it is the same whatever the batch size or the row's place in it.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int P = 16;           // outputs held by each thread
constexpr int TILE = NT * P;    // complex points per block; the longest
                                // row, kernels/fft/plan.py:MAX_LEAF
constexpr int LOG_RADIX = 4;    // radix branch: passes of at most
constexpr int RADIX = 1 << LOG_RADIX;  // RADIX = P points, one a thread
constexpr int MAX_SMEM = 64 * 1024;

struct Tables {
  const float* __restrict__ wr;   // radix: W_n^k (n,); four-step: W1 (n1, n1)
  const float* __restrict__ wi;
  const float* __restrict__ tr;   // four-step: T^T (n2, n1), T^T[i2, o1]
  const float* __restrict__ ti;
  const float* __restrict__ w2r;  // four-step: W2 (n2, n2)
  const float* __restrict__ w2i;
};

struct Geom {
  int n, log_n;     // transform length
  int n1, log_n1;   // four-step factors; n1 == 0 selects the radix branch
  int n2, log_n2;
  int R, log_R;     // rows (K2: columns) staged per block
  int ld;           // shared-memory row stride, in floats
  int log_w;        // radix branch: a warp takes 2^log_w adjacent columns
                    // of 32 / 2^log_w rows (make_geom)
};

__device__ __forceinline__ void cmac(float xr, float xi, float wr, float wi,
                                     float& ar, float& ai) {
  ar = fmaf(xr, wr, ar);
  ar = fmaf(-xi, wi, ar);
  ai = fmaf(xr, wi, ai);
  ai = fmaf(xi, wr, ai);
}

// (ar + i ai) * (br + i bi), rounded as the plain PyTorch version rounds it
__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& yr, float& yi) {
  yr = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
  yi = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
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

// The radix branch of tile_dft at n = 2^LOG_N <= 256: n = A * B, A =
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

// The four-step branch of tile_dft, n > 256.
__device__ void tile_four_step(float* sr, float* si, const Geom& g,
                               const Tables& tb) {
  const int t = threadIdx.x;
  float ar[P], ai[P];
#pragma unroll
  for (int k = 0; k < P; ++k) ar[k] = ai[k] = 0.f;

  const int n1 = g.n1, n2 = g.n2;
  const int bs = n1 + 1;  // stride of the transposed intermediate B^T
  {
    // column DFTs + inner twiddle; each thread owns one i2
    const int i2 = t & (n2 - 1);
    const int q0 = t >> g.log_n2, qstep = NT >> g.log_n2;
    for (int i1 = 0; i1 < n1; ++i1) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int q = q0 + k * qstep;
        const int r = q >> g.log_n1, o1 = q & (n1 - 1);
        if (r < g.R) {
          const int xs = r * g.ld + i1 * n2 + i2;
          cmac(sr[xs], si[xs], __ldg(tb.wr + i1 * n1 + o1),
               __ldg(tb.wi + i1 * n1 + o1), ar[k], ai[k]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = q0 + k * qstep;
      const int r = q >> g.log_n1, o1 = q & (n1 - 1);
      if (r < g.R) {
        float br, bi;
        cmul(ar[k], ai[k], __ldg(tb.tr + i2 * n1 + o1),
             __ldg(tb.ti + i2 * n1 + o1), br, bi);
        sr[r * g.ld + i2 * bs + o1] = br;
        si[r * g.ld + i2 * bs + o1] = bi;
      }
      ar[k] = ai[k] = 0.f;
    }
    __syncthreads();
  }
  // row DFTs; each thread owns one o1, output index o2*n1 + o1
  const int o1 = t & (n1 - 1);
  const int q0 = t >> g.log_n1, qstep = NT >> g.log_n1;
  for (int i2 = 0; i2 < n2; ++i2) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = q0 + k * qstep;
      const int r = q >> g.log_n2, o2 = q & (n2 - 1);
      if (r < g.R) {
        const int bsx = r * g.ld + i2 * bs + o1;
        cmac(sr[bsx], si[bsx], __ldg(tb.w2r + i2 * n2 + o2),
             __ldg(tb.w2i + i2 * n2 + o2), ar[k], ai[k]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int q = q0 + k * qstep;
    const int r = q >> g.log_n2, o2 = q & (n2 - 1);
    if (r < g.R) {
      sr[r * g.ld + o2 * n1 + o1] = ar[k];
      si[r * g.ld + o2 * n1 + o1] = ai[k];
    }
  }
  __syncthreads();
}

// Transforms g.R rows of length g.n held in shared memory (row r at
// s[r * g.ld]) in place, natural output order: the radix branch (kRadix,
// n <= 256) or the four-step. Every thread of the block must call it.
template <bool kRadix>
__device__ __forceinline__ void tile_dft(float* sr, float* si, const Geom& g,
                                         const Tables& tb) {
  if constexpr (kRadix) {
    switch (g.log_n) {
      case 1: tile_radix<1>(sr, si, g, tb.wr, tb.wi); break;
      case 2: tile_radix<2>(sr, si, g, tb.wr, tb.wi); break;
      case 3: tile_radix<3>(sr, si, g, tb.wr, tb.wi); break;
      case 4: tile_radix<4>(sr, si, g, tb.wr, tb.wi); break;
      case 5: tile_radix<5>(sr, si, g, tb.wr, tb.wi); break;
      case 6: tile_radix<6>(sr, si, g, tb.wr, tb.wi); break;
      case 7: tile_radix<7>(sr, si, g, tb.wr, tb.wi); break;
      case 8: tile_radix<8>(sr, si, g, tb.wr, tb.wi); break;
      default: break;  // n == 1: the DFT is the identity
    }
  } else {
    tile_four_step(sr, si, g, tb);
  }
}

// K1: block b transforms rows [b*R, b*R + R) of the (rows, n) planes.
template <bool kRadix>
__global__ void __launch_bounds__(NT, kRadix ? 4 : 1)
rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            float* __restrict__ yr, float* __restrict__ yi, long long rows,
            Geom g, Tables tb, const float* __restrict__ er,
            const float* __restrict__ ei, int period) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + g.R * g.ld;
  const long long row0 = (long long)blockIdx.x * g.R;
  const int tot = g.R * g.n;
  for (int f = threadIdx.x; f < tot; f += NT) {
    const int r = f >> g.log_n, i = f & (g.n - 1);
    const long long row = row0 + r;
    const bool in = row < rows;
    sr[r * g.ld + i] = in ? xr[row * g.n + i] : 0.f;
    si[r * g.ld + i] = in ? xi[row * g.n + i] : 0.f;
  }
  __syncthreads();
  tile_dft<kRadix>(sr, si, g, tb);
  for (int f = threadIdx.x; f < tot; f += NT) {
    const int r = f >> g.log_n, o = f & (g.n - 1);
    const long long row = row0 + r;
    if (row >= rows) continue;
    float vr = sr[r * g.ld + o], vi = si[r * g.ld + o];
    if (er != nullptr) {
      const int e = (int)(row & (period - 1)) * g.n + o;
      cmul(vr, vi, __ldg(er + e), __ldg(ei + e), vr, vi);
    }
    yr[row * g.n + o] = vr;
    yi[row * g.n + o] = vi;
  }
}

// K2: block (b, j) transforms columns [j*R, j*R + R) of matrix b of the
// (B, L, C) planes; L = g.n. The (L, R) tile is read R consecutive floats
// a matrix row and held transposed (one column per shared-memory row). A
// warp's load fills whole 32-byte sectors only when R >= 8 (L <= 512);
// at L = 1024 (R = 4) it uses half of each sector, at L = 4096 (R = 1) an
// eighth.
template <bool kRadix>
__global__ void __launch_bounds__(NT, kRadix ? 4 : 1)
cols_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            float* __restrict__ yr, float* __restrict__ yi, int C,
            int tiles_per_b, Geom g, Tables tb, const float* __restrict__ er,
            const float* __restrict__ ei, int col_major) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + g.R * g.ld;
  const long long b = blockIdx.x / tiles_per_b;
  const int c0 = (blockIdx.x % tiles_per_b) * g.R;
  const int L = g.n;
  const int tot = g.R * L;
  const long long base = b * L * (long long)C + c0;
  for (int f = threadIdx.x; f < tot; f += NT) {
    const int r = f & (g.R - 1), l = f >> g.log_R;
    sr[r * g.ld + l] = xr[base + (long long)l * C + r];
    si[r * g.ld + l] = xi[base + (long long)l * C + r];
  }
  __syncthreads();
  tile_dft<kRadix>(sr, si, g, tb);
  for (int f = threadIdx.x; f < tot; f += NT) {
    int r, o;
    long long dst;
    if (col_major) {  // out[b, o, c]
      r = f & (g.R - 1);
      o = f >> g.log_R;
      dst = base + (long long)o * C + r;
    } else {          // out[b*C + c, o]
      r = f >> g.log_n;
      o = f & (L - 1);
      dst = (b * C + c0 + r) * (long long)L + o;
    }
    float vr = sr[r * g.ld + o], vi = si[r * g.ld + o];
    if (er != nullptr) {
      const int e = (c0 + r) * L + o;
      cmul(vr, vi, __ldg(er + e), __ldg(ei + e), vr, vi);
    }
    yr[dst] = vr;
    yi[dst] = vi;
  }
}

// K3: block b transforms real rows [b*R, b*R + R) of x (rows, 2m), packed
// as m complex points each; g.n = m. untangle != 0 writes the one-sided
// (rows, m+1) spectrum (untangle_half_spectrum, rounded as the plain
// version rounds it), untangle == 0 the packed (rows, m) half spectrum.
template <bool kRadix>
__global__ void __launch_bounds__(NT, kRadix ? 4 : 1)
rfft_kernel(const float2* __restrict__ x, float* __restrict__ yr,
            float* __restrict__ yi, long long rows, Geom g, Tables tb,
            const float* __restrict__ vr, const float* __restrict__ vi,
            int untangle) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + g.R * g.ld;
  const long long row0 = (long long)blockIdx.x * g.R;
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
  tile_dft<kRadix>(sr, si, g, tb);
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
      // E = (Y[k] + conj(P))/2, O = (Y[k] - conj(P))/2i, P = Y[(m-k) % m]
      const int kk = k < m ? k : 0;
      const int p = (m - kk) & (m - 1);
      const float er = __fmul_rn(0.5f, __fadd_rn(ar[kk], ar[p]));
      const float ei = __fmul_rn(0.5f, __fsub_rn(ai[kk], ai[p]));
      const float our = __fmul_rn(0.5f, __fadd_rn(ai[kk], ai[p]));
      const float oui = __fmul_rn(0.5f, __fsub_rn(ar[p], ar[kk]));
      if (k < m) {  // X[k] = E + v[k] O
        const float wr = __ldg(vr + k), wi = __ldg(vi + k);
        xr = __fsub_rn(__fadd_rn(er, __fmul_rn(wr, our)), __fmul_rn(wi, oui));
        xi = __fadd_rn(__fadd_rn(ei, __fmul_rn(wr, oui)), __fmul_rn(wi, our));
      } else {      // Nyquist X[m] = E[0] - O[0], real
        xr = __fsub_rn(er, our);
        xi = 0.f;
      }
    }
    yr[row * w + k] = xr;
    yi[row * w + k] = xi;
  }
}

int log2i(int v) {
  int p = 0;
  while ((1 << p) < v) ++p;
  return p;
}

// The shared-memory row stride ld, in floats, and the radix passes' warp
// shape. Four-step: room for B^T (stride n1 + 1) as well as x. Radix: room
// for the intermediate (i2 at stride RADIX + 1), 17b - 1 floats for
// n = 16b >= 32, and n below.
//   K1, K3 (no pad): ld is the least odd multiple of b (b = 1 for n <= 16):
//   17b for n >= 32, n + 1 below. A warp of either radix pass takes w = b
//   adjacent columns of 32 / b rows, and each access of both passes —
//   x at r*ld + i1*b + i2, the intermediate at r*ld + i2*(RADIX+1) + o1,
//   y at r*ld + o2*RADIX + o1 — falls in 32 different banks: the warp's w
//   columns differ mod w (RADIX + 1 is odd) and its rows lie at distinct
//   multiples of w mod 32 (ld / w is odd).
//   K2 (pad): the transposing load's rule below fixes ld % 32; the radix
//   passes then take w = the largest power of two dividing ld (at most b),
//   conflict-free by the same argument whenever R * w >= 32.
Geom make_geom(int n, int n1, int n2, int R, bool pad) {
  Geom g;
  g.n = n;
  g.log_n = log2i(n);
  g.n1 = n1;
  g.log_n1 = n1 ? log2i(n1) : 0;
  g.n2 = n2;
  g.log_n2 = n2 ? log2i(n2) : 0;
  g.R = R;
  g.log_R = log2i(R);
  const int b = n > RADIX ? n / RADIX : 1;
  const int base = n1 ? n2 * (n1 + 1) : (b > 1 ? (RADIX + 1) * b - 1 : n);
  int ld = base;
  if (pad) {
    // K2's transposing load has a warp write R columns x (32 / R) rows of
    // the tile: choose ld % 32 == 32 / R (odd when R >= 32) so that those
    // 32 words fall in 32 different banks
    if (base < 32) {
      ld = base | 1;
    } else {
      const int target = R < 32 ? 32 / R : 1;
      ld = base + (((target - base) % 32) + 32) % 32;
    }
  } else if (!n1) {
    ld = (base + b - 1) / b * b;
    if (!((ld / b) & 1)) ld += b;
  }
  g.ld = ld;
  g.log_w = 0;
  while (g.log_w < LOG_RADIX && !(ld & (1 << g.log_w))) ++g.log_w;
  return g;
}

int smem_bytes(const Geom& g) { return 2 * g.R * g.ld * (int)sizeof(float); }

// Launches one instantiation of a kernel with the tile's shared memory.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long blocks, const Geom& g,
           void* stream, Args... args) {
  const int smem = smem_bytes(g);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MAX_SMEM);
  kernel<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The leaf's branch: the radix FFT (n1 == 0) only up to 256 points.
bool valid_split(int n, int n1, int n2) {
  return n1 ? n1 * n2 == n : n <= RADIX * RADIX;
}

}  // namespace

extern "C" {

// Returns 0, or the CUDA error code of the launch.
int matfft_rows(const float* xr, const float* xi, float* yr, float* yi,
                long long rows, int n, int n1, int n2, const float* wr,
                const float* wi, const float* tr, const float* ti,
                const float* w2r, const float* w2i, const float* er,
                const float* ei, int period, void* stream) {
  if (n < 1 || n > TILE || (n & (n - 1)) || !valid_split(n, n1, n2))
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(n, n1, n2, TILE / n, false);
  const Tables tb{wr, wi, tr, ti, w2r, w2i};
  const long long blocks = (rows + g.R - 1) / g.R;
  if (blocks == 0) return 0;
  return launch(n1 ? rows_kernel<false> : rows_kernel<true>, blocks, g,
                stream, xr, xi, yr, yi, rows, g, tb, er, ei, period);
}

int matfft_cols(const float* xr, const float* xi, float* yr, float* yi,
                long long B, int L, int C, int n1, int n2, const float* wr,
                const float* wi, const float* tr, const float* ti,
                const float* w2r, const float* w2i, const float* er,
                const float* ei, int col_major, void* stream) {
  if (L < 1 || L > TILE || (L & (L - 1)) || C < 1 || (C & (C - 1)) ||
      !valid_split(L, n1, n2))
    return (int)cudaErrorInvalidValue;
  const int R = TILE / L < C ? TILE / L : C;
  const Geom g = make_geom(L, n1, n2, R, true);
  const Tables tb{wr, wi, tr, ti, w2r, w2i};
  const int tiles_per_b = C / R;
  const long long blocks = B * tiles_per_b;
  if (blocks == 0) return 0;
  return launch(n1 ? cols_kernel<false> : cols_kernel<true>, blocks, g,
                stream, xr, xi, yr, yi, C, tiles_per_b, g, tb, er, ei,
                col_major);
}

// x: real (rows, 2m), 8-byte aligned; yr, yi: (rows, m+1) with untangle,
// (rows, m) without; n1, n2, wr..w2i: the leaf tables at length m.
int matfft_rfft(const float* x, float* yr, float* yi, long long rows, int m,
                int n1, int n2, const float* wr, const float* wi,
                const float* tr, const float* ti, const float* w2r,
                const float* w2i, const float* vr, const float* vi,
                int untangle, void* stream) {
  if (m < 2 || m > TILE || (m & (m - 1)) || ((size_t)x & 7) ||
      !valid_split(m, n1, n2))
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(m, n1, n2, TILE / m, false);
  const Tables tb{wr, wi, tr, ti, w2r, w2i};
  const long long blocks = (rows + g.R - 1) / g.R;
  if (blocks == 0) return 0;
  return launch(n1 ? rfft_kernel<false> : rfft_kernel<true>, blocks, g,
                stream, reinterpret_cast<const float2*>(x), yr, yi, rows, g,
                tb, vr, vi, untangle);
}

}  // extern "C"
