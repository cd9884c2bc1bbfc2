// Min-plus (tropical) matrix product for Hopper: out[i,j] = min_k A[i,k] + B[k,j].
//
// Replaces: src/repro/kernels/minplus.py:minplus_pallas, the Pallas TPU
// kernel that walks k-panels of +inf-padded tiles and keeps a running
// minimum in the output tile.
//
// Used by every APSP product of the main path: the hub Bellman-Ford rounds
// (h, n) x (n, n), the hub composition (n, h) x (h, n), and the exact
// squarings (n, n) x (n, n) below HUB_MIN_N.
//
// What bounds it on the card: the tropical semiring has no
// multiply-accumulate, so neither the tensor cores nor FMA apply.  Each
// (i, k, j) costs one fp32 add and one fp32 min on the CUDA cores, 2 m k n
// operations in all; at (140, 19412) x (19412, 19412) that is 1.1e11
// operations, 1.6 ms at the 67 TFLOP/s fp32 rate (which counts an FMA as
// two operations; as issued instructions it is twice that).  The bytes
// (A, B and out once each) are 1.5 GB, 0.45 ms, so the kernel is bound by
// operations, and the design keeps the operands in registers and shared
// memory.
//
// Design: one block of 256 threads owns a 64 x 64 output tile.  k is
// walked in panels of 16: the 64 x 16 panel of A and the 16 x 64 panel of
// B are staged in shared memory, and every thread keeps a 4 x 4 register
// tile of running minima (8 shared loads per 32 operations).  Entries
// past the ragged edges of m, k or n read as +inf, the tropical zero, so
// no padded copy is made.  The kernel never writes into A or B (apsp_exact
// squares D into a fresh buffer).  The minimum of exactly rounded sums
// does not depend on the order in which they are taken, so the result is
// bitwise equal to the plain version's.  The minimum is PTX min.NaN.f32,
// which returns NaN when either operand is NaN: a NaN input reaches every
// output it is summed into, as in the plain version (torch.amin /
// torch.minimum) and the JAX kernel (jnp.min / jnp.minimum); fminf would
// drop it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

// min(a, b) that returns NaN if either operand is NaN (sm_80 and later)
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ out, int m, int k, int n) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];

  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const int i0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = INFINITY;

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // A panel: rows i0 .. i0+63, columns k0 .. k0+15
      const int ra = (t >> 4) + 16 * q;
      const int ka = t & 15;
      const int gi = i0 + ra;
      const int gka = k0 + ka;
      As[ka][ra] = (gi < m && gka < k) ? A[(int64_t)gi * k + gka] : INFINITY;
      // B panel: rows k0 .. k0+15, columns j0 .. j0+63
      const int kb = (t >> 6) + 4 * q;
      const int cb = t & 63;
      const int gkb = k0 + kb;
      const int gj = j0 + cb;
      Bs[kb][cb] = (gkb < k && gj < n) ? B[(int64_t)gkb * n + gj] : INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = min_nan(acc[r][c], __fadd_rn(a[r], b[c]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty + 16 * r;
    if (gi >= m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tx + 16 * c;
      if (gj < n) out[(int64_t)gi * n + gj] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int repro_minplus(const void* A, const void* B, void* out, int m,
                             int k, int n, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  minplus_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)B, (float*)out, m, k, n);
  return (int)cudaGetLastError();
}
