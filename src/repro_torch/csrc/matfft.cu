// Hand-written Hopper kernels for the matrix-DFT leaf transforms.
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
// columns of one (L, C) matrix for K2), transforms them in place, and
// stores them with the optional epilogue (K1, K2) or the untangle (K3)
// fused into the store.
//
//   n <= 256   direct DFT: y[r, o] = sum_i x[r, i] W[i, o]
//   n  > 256   four-step with n = n1 * n2 (i = i1*n2 + i2, o = o2*n1 + o1):
//                B[o1, i2] = T[o1, i2] * sum_i1 x[i1*n2 + i2] W1[i1, o1]
//                y[o2*n1 + o1] = sum_i2 B[o1, i2] W2[i2, o2]
//
// The tables W, W1, W2 and T are the plan's float32 tables, computed in
// float64 on the host (kernels/fft/plan.py) and read through the read-only
// cache; no sin/cos is evaluated on the card.
//
// What bounds it on an H100: the matrix formulation issues 4*n*(n1+n2)
// real FMAs per row (4*n*n for the direct DFT) against 16*n bytes of
// device memory traffic, so a batch is bound by f32 FMA issue and by
// shared-memory operand reads, not by HBM. The design keeps every
// intermediate in shared memory (one HBM read and one write per point),
// holds each thread's 16 outputs in registers so the in-place update needs
// no second buffer, and lays the intermediate out so that each warp reads
// consecutive shared-memory words and one table entry (a broadcast). It
// uses IEEE f32 FMAs on the CUDA cores: no TF32 and no tensor cores.
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
// about half the FMAs of the complex transform of the same row. The
// output row stride m+1 is odd, so its stores are scalar.
//
// A row's result depends only on its own values: every output is a
// sequential fmaf chain in a fixed order, with no reduction across rows,
// so it is the same whatever the batch size or the row's place in it.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int P = 16;           // outputs held by each thread
constexpr int TILE = NT * P;    // complex points per block; the longest
                                // row, kernels/fft/plan.py:MAX_LEAF
constexpr int MAX_SMEM = 64 * 1024;

struct Tables {
  const float* __restrict__ wr;   // direct: W (n, n); four-step: W1 (n1, n1)
  const float* __restrict__ wi;
  const float* __restrict__ tr;   // four-step: T^T (n2, n1), T^T[i2, o1]
  const float* __restrict__ ti;
  const float* __restrict__ w2r;  // four-step: W2 (n2, n2)
  const float* __restrict__ w2i;
};

struct Geom {
  int n, log_n;     // transform length
  int n1, log_n1;   // four-step factors; n1 == 0 selects the direct DFT
  int n2, log_n2;
  int R, log_R;     // rows (K2: columns) staged per block
  int ld;           // shared-memory row stride, in floats
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

// Transforms g.R rows of length g.n held in shared memory (row r at
// s[r * g.ld]) in place, natural output order. Every thread of the block
// must call it.
__device__ void tile_dft(float* sr, float* si, const Geom& g,
                         const Tables& tb) {
  const int t = threadIdx.x;
  float ar[P], ai[P];
#pragma unroll
  for (int k = 0; k < P; ++k) ar[k] = ai[k] = 0.f;

  if (g.n1 == 0) {
    // direct DFT; n divides NT, so each thread owns one column o
    const int n = g.n;
    const int o = t & (n - 1);
    const int r0 = t >> g.log_n, rstep = NT >> g.log_n;
    for (int i = 0; i < n; ++i) {
      const float wr = __ldg(tb.wr + i * n + o);
      const float wi = __ldg(tb.wi + i * n + o);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int r = r0 + k * rstep;
        if (r < g.R) cmac(sr[r * g.ld + i], si[r * g.ld + i], wr, wi,
                          ar[k], ai[k]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int r = r0 + k * rstep;
      if (r < g.R) {
        sr[r * g.ld + o] = ar[k];
        si[r * g.ld + o] = ai[k];
      }
    }
    __syncthreads();
    return;
  }

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

// K1: block b transforms rows [b*R, b*R + R) of the (rows, n) planes.
__global__ void __launch_bounds__(NT)
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
  tile_dft(sr, si, g, tb);
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
__global__ void __launch_bounds__(NT)
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
  tile_dft(sr, si, g, tb);
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
__global__ void __launch_bounds__(NT)
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
  tile_dft(sr, si, g, tb);
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
  const int base = n1 ? n2 * (n1 + 1) : n;  // room for B^T as well as x
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
  }
  g.ld = ld;
  return g;
}

int smem_bytes(const Geom& g) { return 2 * g.R * g.ld * (int)sizeof(float); }

}  // namespace

extern "C" {

// Returns 0, or the CUDA error code of the launch.
int matfft_rows(const float* xr, const float* xi, float* yr, float* yi,
                long long rows, int n, int n1, int n2, const float* wr,
                const float* wi, const float* tr, const float* ti,
                const float* w2r, const float* w2i, const float* er,
                const float* ei, int period, void* stream) {
  if (n < 1 || n > TILE || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(n, n1, n2, TILE / n, false);
  const Tables tb{wr, wi, tr, ti, w2r, w2i};
  const long long blocks = (rows + g.R - 1) / g.R;
  if (blocks == 0) return 0;
  const int smem = smem_bytes(g);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MAX_SMEM);
  rows_kernel<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, rows, g, tb, er, ei, period);
  return (int)cudaGetLastError();
}

int matfft_cols(const float* xr, const float* xi, float* yr, float* yi,
                long long B, int L, int C, int n1, int n2, const float* wr,
                const float* wi, const float* tr, const float* ti,
                const float* w2r, const float* w2i, const float* er,
                const float* ei, int col_major, void* stream) {
  if (L < 1 || L > TILE || (L & (L - 1)) || C < 1 || (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  const int R = TILE / L < C ? TILE / L : C;
  const Geom g = make_geom(L, n1, n2, R, true);
  const Tables tb{wr, wi, tr, ti, w2r, w2i};
  const int tiles_per_b = C / R;
  const long long blocks = B * tiles_per_b;
  if (blocks == 0) return 0;
  const int smem = smem_bytes(g);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MAX_SMEM);
  cols_kernel<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, C, tiles_per_b, g, tb, er, ei, col_major);
  return (int)cudaGetLastError();
}

// x: real (rows, 2m), 8-byte aligned; yr, yi: (rows, m+1) with untangle,
// (rows, m) without; n1, n2, wr..w2i: the leaf tables at length m.
int matfft_rfft(const float* x, float* yr, float* yi, long long rows, int m,
                int n1, int n2, const float* wr, const float* wi,
                const float* tr, const float* ti, const float* w2r,
                const float* w2i, const float* vr, const float* vi,
                int untangle, void* stream) {
  if (m < 2 || m > TILE || (m & (m - 1)) || ((size_t)x & 7))
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(m, n1, n2, TILE / m, false);
  const Tables tb{wr, wi, tr, ti, w2r, w2i};
  const long long blocks = (rows + g.R - 1) / g.R;
  if (blocks == 0) return 0;
  const int smem = smem_bytes(g);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rfft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MAX_SMEM);
  rfft_kernel<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(x), yr, yi, rows, g, tb, vr, vi,
      untangle);
  return (int)cudaGetLastError();
}

}  // extern "C"
