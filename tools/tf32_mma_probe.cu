// The issue rate of mma.sync TF32 on the card, built and run by
// tools/flash_bwd_bench.py --probe: the ceiling of the split-TF32 fp32
// backward (csrc/flash_attention_bwd_tf32x3.cu), whose products are all
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.
//
// Each warp keeps kChains independent 16 x 8 accumulators and issues one
// product into each of them per round, its operands from registers (no
// loads, no splits), for `iters` rounds; the caller divides 2 * 16 * 8 * 8
// flops a product by the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(256) mma_kernel(float* out, int iters) {
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + 1e-3f * (threadIdx.x + i)) & 0xFFFFE000u;
  const uint32_t b0 = __float_as_uint(0.5f), b1 = __float_as_uint(0.25f);
  float d[kChains][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[c][e] = 0.f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma_tf32(d[c], a, b0, b1);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// blocks of 256 threads; *products = mma.sync products a warp per round
extern "C" int probe_run(float* out, int blocks, int iters, int* products) {
  *products = kChains;
  mma_kernel<<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
