// One multi-source relaxation round over a row-sorted CSR graph, for Hopper.
//
// Replaces: src/repro/kernels/sparse_apsp.py:gather_add_pallas, the Pallas
// TPU tile cand[s, e] = D[s, cols[e]] + vals[e] with the distance row panel
// resident in VMEM, and the scatter-min that sparse_relax composes around
// it in XLA.  Here the gather, the add and the segmented minimum are one
// kernel, so the (s, 2E) candidate matrix never exists:
//
//   out[s, v] = min(D[s, v],  min over e in row v of  D[s, cols[e]] + vals[e])
//
// It reads D and writes a second buffer (Jacobi order, as the plain version
// sparse_relax_ref does), and sets *changed to 1 if any out[s, v] < D[s, v]
// (the caller zeroes it before the launch), so a Bellman-Ford loop reads
// back one int per round.  The minimum is PTX min.NaN.f32: a NaN in D or
// vals reaches every output it is summed into, as torch.segment_reduce and
// torch.minimum propagate it in the plain version.  The minimum of exactly
// rounded sums does not depend on the order in which they are taken, so
// every non-NaN output is bitwise the plain version's, and so is the fixed
// point.
//
// What bounds it on the card: at the Crop shape (s = 140 hub rows,
// n = 19412, 2(3n - 6) = 116460 CSR entries) one round must read D and
// write out (2 x 10.9 MB) and read the CSR once (1.0 MB): 6.8 us at
// 3.35 TB/s.  It does 2 s E operations (an add and a min per source and
// entry), 3.3e7, 0.5 us at 67 TFLOP/s, so it is bound by bytes.  The
// gathers D[s, cols[e]] touch each D row about 2E / n = 6 times; D (10.9 MB)
// stays in the 50 MB L2, so the repeats come from L2, not device memory.
//
// Design: one thread per (vertex v, group of kSrc sources).  The thread
// walks its row's CSR entries once, loading cols[e] and vals[e] once for
// kSrc sources, and keeps the kSrc running minima in registers.
// Neighbouring threads own neighbouring vertices, so the indptr reads and
// the D[s, v] / out[s, v] accesses are coalesced; the CSR segments of
// neighbouring rows are adjacent in memory.  The changed flag is written
// once per warp that saw a decrease.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSrc = 8;

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__global__ void __launch_bounds__(kThreads)
sparse_relax_kernel(const float* __restrict__ D, const int* __restrict__ indptr,
                    const int* __restrict__ cols,
                    const float* __restrict__ vals, float* __restrict__ out,
                    int* __restrict__ changed, int s, int n) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int s0 = blockIdx.y * kSrc;
  const int ns = min(kSrc, s - s0);
  bool dec = false;
  if (v < n) {
    float d0[kSrc], acc[kSrc];
#pragma unroll
    for (int j = 0; j < kSrc; ++j) {
      d0[j] = j < ns ? D[(int64_t)(s0 + j) * n + v] : 0.0f;
      acc[j] = d0[j];
    }
    const int e1 = indptr[v + 1];
    for (int e = indptr[v]; e < e1; ++e) {
      const int u = cols[e];
      const float w = vals[e];
#pragma unroll
      for (int j = 0; j < kSrc; ++j)
        if (j < ns)
          acc[j] = min_nan(acc[j], __fadd_rn(D[(int64_t)(s0 + j) * n + u], w));
    }
#pragma unroll
    for (int j = 0; j < kSrc; ++j) {
      if (j < ns) {
        out[(int64_t)(s0 + j) * n + v] = acc[j];
        dec |= acc[j] < d0[j];
      }
    }
  }
  if (__any_sync(0xffffffffu, dec) && (threadIdx.x & 31) == 0) *changed = 1;
}

}  // namespace

extern "C" int repro_sparse_relax(const void* D, const void* indptr,
                                  const void* cols, const void* vals,
                                  void* out, void* changed, int s, int n,
                                  void* stream) {
  if (s <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kThreads - 1) / kThreads, (s + kSrc - 1) / kSrc);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  sparse_relax_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)D, (const int*)indptr, (const int*)cols,
      (const float*)vals, (float*)out, (int*)changed, s, n);
  return (int)cudaGetLastError();
}
