// Hand-written Hopper kernel for the radix-2 Stockham FFT (K4).
//
//   stockham_rows  forward DFT along the last axis of planar (rows, n) f32,
//                  n a power of two, 2 <= n <= 4096, natural-order output.
//                  Replaces repro/kernels/fft/stockham.py:stockham_fft
//                  (Pallas body _stockham_kernel).
//
// A block holds R = TILE / n whole rows, planar, in shared memory (32 KB)
// and runs the log2 n decimation-in-frequency stages on them. Stage s has
// l = n >> (s+1) twiddles at offset off of the packed table
// (kernels/fft/plan.py:stockham_twiddles) and sub-length m = 2^s, exactly
// plan.stockham_stage_offsets(n). Viewing a row as x[h, j, k] at
// h*l*m + j*m + k, each butterfly
//     y[j, 0, k] = a + b,   y[j, 1, k] = (a - b) * w[off + j]
// with a = x[0, j, k], b = x[1, j, k], writes y[j, t, k] at j*2m + t*m + k.
// Each thread reads its 8 butterflies' operands into registers, the block
// synchronises, and then it overwrites the row in place: no second buffer.
// The twiddles are the plan's float32 table (no sin/cos on the card), and
// every product is rounded as the plain PyTorch version rounds it.
//
// What bounds it on an H100: 16 bytes of device memory traffic a point
// against 5 log2 n / 2 flops a point, so at n = 1024 about 1.6 flops a
// byte, far below the card's f32 ridge: it is bound by bytes, and the
// design touches device memory once a point each way (coalesced, one
// contiguous R*n span a block). Within the block, a warp's 32 butterflies
// read 32 consecutive words in every stage; their stores go to
// j*2m + t*m + k, which for the first five stages (m = 1, 2, ..., 16)
// spreads a warp's 32 words over 64: two-way bank conflicts, left in this
// version.
//
// A row's result depends only on its own values, so it is the same
// whatever the batch size or the row's place in it.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int TILE = 4096;         // complex points per block
constexpr int BF = TILE / 2 / NT;  // butterflies per thread per stage

__global__ void __launch_bounds__(NT)
stockham_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                long long rows, int n, int log_n,
                const float* __restrict__ twr,
                const float* __restrict__ twi) {
  __shared__ float sr[TILE];
  __shared__ float si[TILE];
  const int R = TILE >> log_n;
  const long long base = (long long)blockIdx.x * R * n;
  const long long total = rows * n;
  for (int f = threadIdx.x; f < TILE; f += NT) {
    const bool in = base + f < total;
    sr[f] = in ? xr[base + f] : 0.f;
    si[f] = in ? xi[base + f] : 0.f;
  }
  __syncthreads();

  const int half = n >> 1;
  const int log_half = log_n - 1;
  int off = 0, l = half, log_m = 0;
  for (int s = 0; s < log_n; ++s) {
    const int m = 1 << log_m;
    float y0r[BF], y0i[BF], y1r[BF], y1i[BF];
#pragma unroll
    for (int u = 0; u < BF; ++u) {
      const int b = threadIdx.x + u * NT;  // butterfly index in the block
      const int r = b >> log_half, q = b & (half - 1);
      const int j = q >> log_m, k = q & (m - 1);
      const int ia = r * n + j * m + k;
      const float ar = sr[ia], ai = si[ia];
      const float br = sr[ia + half], bi = si[ia + half];
      const float wr = __ldg(twr + off + j), wi = __ldg(twi + off + j);
      const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
      y0r[u] = __fadd_rn(ar, br);
      y0i[u] = __fadd_rn(ai, bi);
      y1r[u] = __fsub_rn(__fmul_rn(wr, dr), __fmul_rn(wi, di));
      y1i[u] = __fadd_rn(__fmul_rn(wr, di), __fmul_rn(wi, dr));
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < BF; ++u) {
      const int b = threadIdx.x + u * NT;
      const int r = b >> log_half, q = b & (half - 1);
      const int j = q >> log_m, k = q & (m - 1);
      const int io = r * n + (j << (log_m + 1)) + k;
      sr[io] = y0r[u];
      si[io] = y0i[u];
      sr[io + m] = y1r[u];
      si[io + m] = y1i[u];
    }
    __syncthreads();
    off += l;
    l >>= 1;
    ++log_m;
  }

  for (int f = threadIdx.x; f < TILE; f += NT) {
    if (base + f < total) {
      yr[base + f] = sr[f];
      yi[base + f] = si[f];
    }
  }
}

}  // namespace

extern "C" {

// Returns 0, or the CUDA error code of the launch. tw_r, tw_i: the packed
// (n,) per-stage twiddle table of plan.stockham_twiddles(n).
int stockham_rows(const float* xr, const float* xi, float* yr, float* yi,
                  long long rows, int n, const float* tw_r, const float* tw_i,
                  void* stream) {
  if (n < 2 || n > TILE || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const long long R = TILE / n;
  const long long blocks = (rows + R - 1) / R;
  if (blocks == 0) return 0;
  stockham_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, rows, n, log_n, tw_r, tw_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
