// Z = (X - mu) * rs, written once l-major and zero-padded: the operand
// layout shared by pearson.cu and topk.cu, so the two compute every
// correlation with the same operands.
//
// Zt (Lp, Np): Lp = L rounded up to a multiple of 16, Np at least n and a
// multiple of 32, as each caller's tiling needs it (topk.cu: n rounded up
// to 128; pearson.cu: its last tile's 128 columns); zeros past L and n.  Each value is two
// rounded operations, a subtract then a multiply (no contraction).
// One 32 x 32 tile per block of 32 x 8 threads; grid (Np / 32,
// ceil(Lp / 32)).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
standardize_kernel(const float* __restrict__ X, const float* __restrict__ mu,
                   const float* __restrict__ rs, float* __restrict__ zt,
                   int n, int L, int Lp, int Np) {
  __shared__ float tile[32][33];
  const int j0 = blockIdx.x * 32, l0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int rr = ty; rr < 32; rr += 8) {
    const int j = j0 + rr, l = l0 + tx;
    float z = 0.0f;
    if (j < n && l < L) z = (X[(int64_t)j * L + l] - mu[j]) * rs[j];
    tile[rr][tx] = z;
  }
  __syncthreads();
  for (int rr = ty; rr < 32; rr += 8) {
    const int l = l0 + rr;
    if (l < Lp) zt[(int64_t)l * Np + j0 + tx] = tile[tx][rr];
  }
}

// Launch it on stream st for X (n, L) into zt (Lp, Np).
inline void launch_standardize(const float* X, const float* mu,
                               const float* rs, float* zt, int n, int L,
                               int Lp, int Np, cudaStream_t st) {
  standardize_kernel<<<dim3(Np / 32, (Lp + 31) / 32), dim3(32, 8), 0, st>>>(
      X, mu, rs, zt, n, L, Lp, Np);
}

}  // namespace
