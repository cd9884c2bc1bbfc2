// Pearson correlation matrix of the rows of X (n, L), fp32, for Hopper.
//
// Replaces: src/repro/kernels/pearson.py:pearson_pallas, the Pallas TPU
// kernel that standardises each X tile in VMEM right before the MXU
// product and accumulates in fp32.
//
// out[i, j] = clip(sum_l ((X[i,l] - mu[i]) * rs[i]) * ((X[j,l] - mu[j]) * rs[j]),
//                  -1, 1)
// with the row statistics mu (mean) and rs (1 / (sqrt(ss) + eps)) computed
// by the caller in PyTorch, as the JAX wrapper computes them outside its
// kernel.
//
// What bounds it on the card: at the main path's shape (n = 19412,
// L = 46) it writes n^2 * 4 B = 1.5 GB, 0.45 ms at 3.35 TB/s.  The output
// is symmetric, so the function needs only n (n + 1) / 2 dot products,
// n (n + 1) L = 1.7e10 fp32 FLOP, 0.26 ms at 67 TFLOP/s: it is bound by
// the write.  This kernel computes every tile, both halves, so it issues
// twice those FLOP (0.52 ms), which is still near the write.  The tensor
// cores are not used on purpose: their fp32 path is TF32, which keeps
// about three decimal digits, and the similarity feeds discrete TMFG
// decisions.
//
// Design: one block of 256 threads owns a 64 x 64 output tile.  The L
// axis is walked in panels of 16; each panel of the 64 row-series and the
// 64 column-series is standardised while it is loaded into shared memory
// (so the standardised matrix never exists in device memory), and every
// thread accumulates a 4 x 4 register tile with fp32 FMA in increasing l.
// out[i, j] and out[j, i] multiply the same two standardised values in
// the same order, so the result is exactly symmetric.  Ragged edges (n
// or L not a multiple of the tile) are masked on load and on store; no
// padded copy is made.  The clip is applied in the epilogue and passes
// NaN through, as torch.clamp does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 16;        // L panel
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
pearson_kernel(const float* __restrict__ X, const float* __restrict__ mu,
               const float* __restrict__ rs, float* __restrict__ out,
               int n, int L) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];

  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const int i0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int l0 = 0; l0 < L; l0 += kBK) {
    const int kk = t & 15;
    const int gl = l0 + kk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = (t >> 4) + 16 * q;
      const int gi = i0 + r;
      float a = 0.0f;
      if (gi < n && gl < L)
        a = (X[(int64_t)gi * L + gl] - mu[gi]) * rs[gi];
      As[kk][r] = a;
      const int gj = j0 + r;
      float b = 0.0f;
      if (gj < n && gl < L)
        b = (X[(int64_t)gj * L + gl] - mu[gj]) * rs[gj];
      Bs[kk][r] = b;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty + 16 * r;
    if (gi >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tx + 16 * c;
      if (gj >= n) continue;
      float v = acc[r][c];
      v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
      out[(int64_t)gi * n + gj] = v;
    }
  }
}

}  // namespace

extern "C" int repro_pearson(const void* X, const void* mu, const void* rs,
                             void* out, int n, int L, void* stream) {
  if (n <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  pearson_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)mu, (const float*)rs, (float*)out, n,
      L);
  return (int)cudaGetLastError();
}
