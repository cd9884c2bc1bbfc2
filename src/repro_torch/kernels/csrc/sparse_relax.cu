// One multi-source relaxation round over a row-sorted CSR graph, for Hopper.
//
// Replaces: src/repro/kernels/sparse_apsp.py:gather_add_pallas, the Pallas
// TPU tile cand[s, e] = D[s, cols[e]] + vals[e] with the distance row panel
// resident in VMEM, and the scatter-min that sparse_relax composes around
// it in XLA.  Here the gather, the add and the segmented minimum are one
// kernel, so the (s, 2E) candidate matrix never exists:
//
//   out[v, s] = min(Dt[v, s],  min over e in row v of  Dt[cols[e], s] + vals[e])
//
// on the sources-minor layout Dt (n, sp): row v holds the distances of
// vertex v from the s sources, padded to sp, a multiple of 32 (the
// wrapper pads with +inf and transposes; out's padding is never written).
// It reads Dt and writes a second buffer (Jacobi order, as the plain
// version sparse_relax_ref does), and sets *changed to 1 if any
// out[v, s] < Dt[v, s] (the caller zeroes it before the launch), so a
// Bellman-Ford loop reads back one int per round.  The minimum is PTX
// min.NaN.f32: a NaN in Dt or vals reaches every output it is summed
// into, as torch.segment_reduce and torch.minimum propagate it in the
// plain version.  The minimum of exactly rounded sums does not depend on
// the order in which it is taken, so every non-NaN output is bitwise the
// plain version's, and so is the fixed point.
//
// What bounds it on the card: at the Crop shape (s = 140 hub rows,
// n = 19412, 2(3n - 6) = 116460 CSR entries) one round must read D and
// write out (2 x 10.9 MB) and read the CSR once (1.0 MB): 6.8 us at
// 3.35 TB/s.  It does 2 s E operations (an add and a min per source and
// entry), 3.3e7, 0.5 us at 67 TFLOP/s, so it is bound by bytes.  D stays
// in the 50 MB L2 between rounds; what limits a round is the L2 traffic
// of the gathers, 2E reads of one vertex's distances.
//
// Design:
//   * Sources minor.  The first design (one thread per vertex and 8
//     sources, on the (s, n) layout) gathered D[s, u] from 8 rows per
//     entry: a 32-byte sector for every 4-byte value, 522 MB of L2
//     traffic per round at Crop.  Here one warp owns a vertex and its
//     lanes run over the sources, so an entry's gather Dt[u, 0:sp] is sp
//     / 32 coalesced 128-byte loads (five at Crop, 75 MB per round).
//   * Work items, not vertices.  The degrees of a TMFG follow a power law
//     (a random Apollonian network at Crop's n reaches degree 425), and
//     one warp per vertex would wait on its hubs' long rows.  The wrapper
//     cuts every row into items of at most 32 entries (kernels/
//     sparse_apsp.relax_plan, once per graph); a warp takes one item,
//     loads its 32 (col, weight) pairs in one coalesced load and walks
//     them with shuffles, four entries' gathers in flight at a time.  A
//     vertex of one item writes out directly.  The items of a longer row
//     write their minima to a partial row each; the last of them to
//     arrive (an atomic count per row, reset by that item for the next
//     round) folds the partials and Dt[v] into out.  Order does not
//     matter to a minimum, so the fold is bitwise.
//   * A template instance per sp / 32 from 2 to 8 (sources past 256 run
//     in further passes of the same warp), so a lane holds registers
//     only for its own sources: 5 at Crop's 140 hubs.
//   * The changed flag is one word for the whole grid: a warp that saw a
//     decrease reads it and stores 1 only while it is still 0.
//
// On an NVIDIA H100 80GB HBM3 at 700 W a round at Crop's shape takes
// 0.0175-0.0185 ms on a path with random chords and 0.0239-0.0241 ms on a
// random Apollonian network (max degree 425), the first design 0.101 and
// 0.271 ms in the same call, timed by CUDA-graph replay: the Python call
// around it takes longer (tools/approx_kernels_bench.py; PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJ = 8;             // sources per lane per pass, at most

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// items[w] = (vertex, first entry, end entry, partial slot or -1), at most
// 32 entries (one per lane); for a slot, slots[slot] = (the vertex's first
// slot, its number of items);
// counters[first slot] counts the vertex's items that are done.  JM
// sources per lane per pass (JM * 32 = sp for 64 <= sp <= 256; 2 below,
// 8 above), so a lane holds no register for a source past sp.
template <int JM>
__global__ void __launch_bounds__(kThreads)
sparse_relax_kernel(const float* __restrict__ Dt, float* __restrict__ out,
                    const int4* __restrict__ items,
                    const int2* __restrict__ slots, int* counters,
                    float* partial, const int* __restrict__ cols,
                    const float* __restrict__ vals,
                    int* __restrict__ changed, int s, int sp, int n_items) {
  const int w = (int)((blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5);
  if (w >= n_items) return;   // whole warps
  const int lane = threadIdx.x & 31;
  const int4 it = items[w];
  const int v = it.x, e0 = it.y, slot = it.w;
  const int cnt = it.z - e0;
  // this item's entries, one per lane
  int my_u = 0;
  float my_w = 0.0f;
  if (lane < cnt) {
    my_u = cols[e0 + lane];
    my_w = vals[e0 + lane];
  }
  bool dec = false;
  for (int c0 = 0; c0 < sp; c0 += 32 * JM) {
    const int J = min(JM, (sp - c0) >> 5);
    const int64_t col = c0 + lane;
    float acc[JM], d0[JM];
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      d0[j] = 0.0f;
      if (j < J) d0[j] = Dt[(int64_t)v * sp + col + 32 * j];
      acc[j] = slot < 0 ? d0[j] : INFINITY;
    }
    int e = 0;
    for (; e + 4 <= cnt; e += 4) {
      float g[4][JM], wt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int u = __shfl_sync(0xffffffffu, my_u, e + q);
        wt[q] = __shfl_sync(0xffffffffu, my_w, e + q);
        const float* row = Dt + (int64_t)u * sp + col;
#pragma unroll
        for (int j = 0; j < JM; ++j) g[q][j] = j < J ? row[32 * j] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < JM; ++j)
          acc[j] = min_nan(acc[j], __fadd_rn(g[q][j], wt[q]));
    }
    for (; e < cnt; ++e) {
      const int u = __shfl_sync(0xffffffffu, my_u, e);
      const float wt = __shfl_sync(0xffffffffu, my_w, e);
      const float* row = Dt + (int64_t)u * sp + col;
#pragma unroll
      for (int j = 0; j < JM; ++j)
        if (j < J) acc[j] = min_nan(acc[j], __fadd_rn(row[32 * j], wt));
    }
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      if (j >= J) continue;
      if (slot < 0) {
        if (col + 32 * j < s) {
          out[(int64_t)v * sp + col + 32 * j] = acc[j];
          dec |= acc[j] < d0[j];
        }
      } else {
        partial[(int64_t)slot * sp + col + 32 * j] = acc[j];
      }
    }
  }
  if (slot >= 0) {
    // the last of the vertex's items folds the partials into out
    const int2 sl = slots[slot];
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      last = atomicAdd(&counters[sl.x], 1) == sl.y - 1;
      if (last) counters[sl.x] = 0;   // ready for the next round
    }
    last = __shfl_sync(0xffffffffu, last, 0);
    if (last) {
      __threadfence();
      for (int c0 = 0; c0 < sp; c0 += 32 * JM) {
        const int J = min(JM, (sp - c0) >> 5);
        const int64_t col = c0 + lane;
        float d[JM], r[JM];
#pragma unroll
        for (int j = 0; j < JM; ++j) {
          d[j] = j < J ? Dt[(int64_t)v * sp + col + 32 * j] : 0.0f;
          r[j] = d[j];
        }
        // the partials two at a time, every source's load in flight
        int q = sl.x;
        for (; q + 2 <= sl.x + sl.y; q += 2) {
          float a[2][JM];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < JM; ++j)
              a[u][j] = j < J ? __ldcg(&partial[(int64_t)(q + u) * sp + col +
                                                32 * j])
                              : 0.0f;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < JM; ++j) r[j] = min_nan(r[j], a[u][j]);
        }
        if (q < sl.x + sl.y) {
#pragma unroll
          for (int j = 0; j < JM; ++j)
            if (j < J)
              r[j] = min_nan(r[j],
                             __ldcg(&partial[(int64_t)q * sp + col + 32 * j]));
        }
#pragma unroll
        for (int j = 0; j < JM; ++j) {
          if (j < J && col + 32 * j < s) {
            out[(int64_t)v * sp + col + 32 * j] = r[j];
            dec |= r[j] < d[j];
          }
        }
      }
    }
  }
  // one flag for the whole grid: read it first, so that once it is set
  // the other warps do not queue stores on its line
  if (__any_sync(0xffffffffu, dec) && lane == 0 &&
      *(volatile int*)changed == 0)
    *changed = 1;
}

template <int JM>
int launch(const void* Dt, void* out, const void* items, const void* slots,
           void* counters, void* partial, const void* cols, const void* vals,
           void* changed, int s, int sp, int n_items, unsigned blocks,
           cudaStream_t stream) {
  sparse_relax_kernel<JM><<<blocks, kThreads, 0, stream>>>(
      (const float*)Dt, (float*)out, (const int4*)items, (const int2*)slots,
      (int*)counters, (float*)partial, (const int*)cols, (const float*)vals,
      (int*)changed, s, sp, n_items);
  return (int)cudaGetLastError();
}

}  // namespace

// Dt, out (n, sp) f32 with sp a multiple of 32 and s <= sp; items
// (n_items, 4), slots (max(1, n_slots), 2) and counters (max(1, n_slots))
// int32 from kernels/sparse_apsp.relax_plan, the counters zero between
// launches (each launch leaves them so); partial (max(1, n_slots), sp) f32.
extern "C" int repro_sparse_relax(const void* Dt, void* out, const void* items,
                                  const void* slots, void* counters,
                                  void* partial, const void* cols,
                                  const void* vals, void* changed, int s,
                                  int sp, int n_items, void* stream) {
  if (s <= 0 || sp < s || sp % 32 != 0 || n_items <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)n_items * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const unsigned b = (unsigned)blocks;
  cudaStream_t st = (cudaStream_t)stream;
#define RELAX_CASE(J)                                                     \
  case J:                                                                 \
    return launch<J>(Dt, out, items, slots, counters, partial, cols, vals, \
                     changed, s, sp, n_items, b, st);
  // one source per lane runs in the two-source instance: ptxas gives the
  // one-source instance 32 registers and a spill
  switch (sp >= 32 * kMaxJ ? kMaxJ : sp < 64 ? 2 : sp / 32) {
    RELAX_CASE(2)
    RELAX_CASE(3)
    RELAX_CASE(4)
    RELAX_CASE(5)
    RELAX_CASE(6)
    RELAX_CASE(7)
    RELAX_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RELAX_CASE
}
