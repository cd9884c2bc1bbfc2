// Issue-rate ceilings for the min-plus kernel (csrc/minplus.cu), built and
// run by tools/minplus_bench.py on the card.
//
//   which 0: FADD alone, 64 independent chains per thread, from registers
//   which 1: FMNMX alone (PTX min.NaN.f32), the same
//   which 2: acc = min(acc, a + b), 8 x 8 per thread, from registers
//   which 3: the kernel's hot loop alone: a 12 x 8 register tile per
//            thread, 384 threads, operands by LDS.128 from a fixed 16-deep
//            shared panel laid out as the kernel's, no copies, no barriers
//
// Each thread does `iters` rounds; the caller divides the work by the time.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// 64 results per thread per round; the operands change every round
template <int kMode>
__global__ void __launch_bounds__(256) pipe_kernel(float* out, float a0,
                                                   int iters) {
  float acc[8][8], b[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = threadIdx.x * (float)(i + 8 * r);
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = a0 * (float)(i + 1);
  float base = a0;
  for (int it = 0; it < iters; ++it) {
    base = __fadd_rn(base, 1.0f);
    float av[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = __fadd_rn(base, 0.37f * r);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float& x = acc[r][i];
        if (kMode == 0) x = __fadd_rn(x, b[i]);
        else if (kMode == 1) x = min_nan(x, av[r]);
        else x = min_nan(x, __fadd_rn(av[r], b[i]));
      }
  }
  float s = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) s += acc[r][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

constexpr int kBM = 144, kBN = 256, kBK = 16, kThreads = 384;
constexpr int kAP = kBM + 4;
constexpr int kSmemBytes = kBK * (kAP + kBN) * 4;

// 16 x 96 triples per thread per round
__global__ void __launch_bounds__(kThreads, 1) hot_kernel(float* out,
                                                          int iters) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < kBK * (kAP + kBN); i += kThreads)
    sm[i] = (float)((i * 7919) % 1000) * 0.001f;
  __syncthreads();
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* A0 = sm + 4 * ty;
  const float* B0 = sm + kBK * kAP + 4 * tx;
  float acc[12][8];
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 1e30f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float* arow = A0 + kk * kAP;
      const float* brow = B0 + kk * kBN;
      float av[12], bv[8];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(arow + 48 * q);
        av[4 * q] = v.x; av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(brow + 128 * q);
        bv[4 * q] = v.x; bv[4 * q + 1] = v.y;
        bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < 12; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = min_nan(acc[r][c], __fadd_rn(av[r], bv[c]));
    }
    asm volatile("" ::: "memory");   // keep the loads in the round
  }
  float s = 0;
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) s += acc[r][c];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

// Launch probe `which` over `blocks` blocks; returns cudaGetLastError().
// *threads receives the block size and *per_round the results (0, 1) or
// triples (2, 3) one thread computes per round.
extern "C" int ceiling_run(int which, float* out, int blocks, int iters,
                           int* threads, int* per_round) {
  if (which == 3) {
    cudaFuncSetAttribute(hot_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    *threads = kThreads;
    *per_round = kBK * 96;
    hot_kernel<<<blocks, kThreads, kSmemBytes>>>(out, iters);
  } else {
    *threads = 256;
    *per_round = 64;
    if (which == 0) pipe_kernel<0><<<blocks, 256>>>(out, 1.0f, iters);
    else if (which == 1) pipe_kernel<1><<<blocks, 256>>>(out, 1.0f, iters);
    else pipe_kernel<2><<<blocks, 256>>>(out, 1.0f, iters);
  }
  return (int)cudaGetLastError();
}
