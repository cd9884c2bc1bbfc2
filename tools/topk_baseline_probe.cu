// Probe builds of the first top-K Pearson kernel design (row panels of
// 64 rows, one column per thread, per-row candidate buffers sorted by a
// warp when nearly full), to split its time on the card.
//
// A verbatim copy of that kernel's loop with one switch, PROBE, a
// template argument of the kernel:
//   0  the full kernel;
//   1  the FMA loop alone: the tile's values are summed into a sink and
//      no value is filtered, kept or sorted;
//   2  the FMA loop and the filter at its steady state: every row's
//      threshold starts at that row's final k-th pair (thr_v, thr_i,
//      taken from a full run), so only the pairs of the final top-k
//      enter a buffer and no buffer is sorted before the last tile.
// Built and run by tools/approx_kernels_bench.py (--baseline-probes);
// the entry point takes Crop's plan, 64 rows per block.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;                   // columns per tile
constexpr int kGroups = kThreads / kBN;   // row groups; a warp is in one
constexpr int kWarps = kThreads / 32;

// (x, j) ranks before (v, i): NaN first, then value desc, then column asc
__device__ __forceinline__ bool better(float x, int j, float v, int i) {
  const bool xn = isnan(x), vn = isnan(v);
  if (xn != vn) return xn;
  if (!xn && x != v) return x > v;
  return j < i;
}

// Bitonic sort of one row's buffer, best first, by one warp.  Entries from
// `cnt` to `cap` are set to the sentinel (-inf, INT_MAX) first.
__device__ void sort_row(float* bv, int* bi, int cnt, int cap, int lane) {
  for (int p = cnt + lane; p < cap; p += 32) {
    bv[p] = -INFINITY;
    bi[p] = INT_MAX;
  }
  __syncwarp();
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = lane; q < (cap >> 1); q += 32) {
        const int lo = 2 * q - (q & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;   // this run sorts best first
        const float v0 = bv[lo], v1 = bv[hi];
        const int i0 = bi[lo], i1 = bi[hi];
        if (better(v1, i1, v0, i0) == up) {
          bv[lo] = v1;
          bv[hi] = v0;
          bi[lo] = i1;
          bi[hi] = i0;
        }
      }
      __syncwarp();
    }
  }
}

template <int RQ, int PROBE>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ X, const float* __restrict__ mu,
            const float* __restrict__ rs, float* __restrict__ vals,
            int* __restrict__ idx, float* scratch, int n, int L, int k,
            int cap, int Lc, const float* __restrict__ thr_v0,
            const int* __restrict__ thr_i0) {
  constexpr int R = kGroups * RQ;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Zr = reinterpret_cast<float*>(smem);       // [R][Lc]
  float* Zc = Zr + R * Lc;                          // [Lc][kBN]
  float* tail = Zc + Lc * kBN;
  float* bufv;                                      // [R][cap]
  if (scratch) {
    bufv = scratch + (int64_t)blockIdx.x * (2 * R * cap);
  } else {
    bufv = tail;
    tail += 2 * R * cap;
  }
  int* bufi = reinterpret_cast<int*>(bufv + R * cap);   // [R][cap]
  int* cnt = reinterpret_cast<int*>(tail);          // [R]
  float* thrv = reinterpret_cast<float*>(cnt + R);  // [R]
  int* thri = reinterpret_cast<int*>(thrv + R);     // [R]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int c = t % kBN;
  const int g = t / kBN;
  const int i0 = blockIdx.x * R;
  const int nch = (L + Lc - 1) / Lc;   // Lc is a multiple of 4

  // the block's rows, elements l0 .. l0 + lcp of each, standardised
  auto load_rows = [&](int l0, int lcp) {
    for (int p = t; p < R * lcp; p += kThreads) {
      const int r = p / lcp, l = p % lcp;
      const int gi = i0 + r, gl = l0 + l;
      float a = 0.0f;
      if (gi < n && gl < L) a = (X[(int64_t)gi * L + gl] - mu[gi]) * rs[gi];
      Zr[r * Lc + l] = a;
    }
  };

  if (nch == 1) load_rows(0, Lc);
  for (int r = t; r < R; r += kThreads) {
    cnt[r] = 0;
    thrv[r] = -INFINITY;
    thri[r] = INT_MAX;
    if (PROBE == 2 && i0 + r < n) {
      thrv[r] = thr_v0[i0 + r];
      thri[r] = thr_i0[i0 + r];
    }
  }
  float sink = 0.0f;

  for (int j0 = 0; j0 < n; j0 += kBN) {
    float acc[RQ];
#pragma unroll
    for (int q = 0; q < RQ; ++q) acc[q] = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      const int l0 = ch * Lc;
      const int lcp = min(Lc, (L - l0 + 3) & ~3);
      __syncthreads();   // Zr and Zc are free, counts and thresholds settled
      if (nch > 1) load_rows(l0, lcp);
      for (int p = t; p < lcp * kBN; p += kThreads) {
        const int l = p / kBN, cc = p % kBN;
        const int gj = j0 + cc, gl = l0 + l;
        float b = 0.0f;
        if (gj < n && gl < L) b = (X[(int64_t)gj * L + gl] - mu[gj]) * rs[gj];
        Zc[p] = b;
      }
      __syncthreads();

      for (int l = 0; l < lcp; l += 4) {
        const float b0 = Zc[(l + 0) * kBN + c];
        const float b1 = Zc[(l + 1) * kBN + c];
        const float b2 = Zc[(l + 2) * kBN + c];
        const float b3 = Zc[(l + 3) * kBN + c];
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(
              &Zr[(g + kGroups * q) * Lc + l]);
          acc[q] = fmaf(a.x, b0, acc[q]);
          acc[q] = fmaf(a.y, b1, acc[q]);
          acc[q] = fmaf(a.z, b2, acc[q]);
          acc[q] = fmaf(a.w, b3, acc[q]);
        }
      }
    }

    const int gj = j0 + c;
    if (PROBE == 1) {
#pragma unroll
      for (int q = 0; q < RQ; ++q) sink += acc[q];
      continue;
    }
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int r = g + kGroups * q;
      const int gi = i0 + r;
      float v = acc[q];
      if (L & 15) v = __fadd_rn(v, 0.0f);   // pearson.cu's padded FMAs
      v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
      const bool take = gi < n && gj < n && gj != gi &&
                        better(v, gj, thrv[r], thri[r]);
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&cnt[r], __popc(mask));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (take) {
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          bufv[r * cap + pos] = v;
          bufi[r * cap + pos] = gj;
        }
      }
    }
    __syncthreads();

    // make room for the next tile: keep the best k of a nearly full row
    const bool last = j0 + kBN >= n;
    for (int r = warp; r < R; r += kWarps) {
      const int m = cnt[r];
      if (!last && m <= cap - kBN) continue;
      sort_row(bufv + r * cap, bufi + r * cap, m, cap, lane);
      if (lane == 0) {
        cnt[r] = min(m, k);
        if (m >= k) {
          thrv[r] = bufv[r * cap + k - 1];
          thri[r] = bufi[r * cap + k - 1];
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (PROBE == 1) {
    if (sink == 1234.5f) vals[0] = sink;   // keeps the FMAs alive
    return;
  }

  for (int r = warp; r < R; r += kWarps) {
    const int gi = i0 + r;
    if (gi >= n) continue;
    for (int s = lane; s < k; s += 32) {
      vals[(int64_t)gi * k + s] = bufv[r * cap + s];
      idx[(int64_t)gi * k + s] = bufi[r * cap + s];
    }
  }
}

template <int PROBE>
int launch(const float* X, const float* mu, const float* rs, float* vals,
           int* idx, float* scratch, const float* tv, const int* ti, int n,
           int L, int k, int cap, int Lc, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<16, PROBE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  topk_kernel<16, PROBE><<<(n + 63) / 64, kThreads, smem, stream>>>(
      X, mu, rs, vals, idx, scratch, n, L, k, cap, Lc, tv, ti);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int topk_baseline_probe(const void* X, const void* mu,
                                   const void* rs, void* vals, void* idx,
                                   const void* thr_v, const void* thr_i,
                                   int n, int L, int k, int rows_per_block,
                                   int cap, int Lc, int smem, int probe,
                                   void* stream) {
  if (rows_per_block != 64 || n <= 1 || k < 1 || k > n - 1)
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)X;
  const float* m = (const float*)mu;
  const float* r = (const float*)rs;
  float* v = (float*)vals;
  int* i = (int*)idx;
  const float* tv = (const float*)thr_v;
  const int* ti = (const int*)thr_i;
  cudaStream_t st = (cudaStream_t)stream;
  switch (probe) {
    case 0: return launch<0>(x, m, r, v, i, nullptr, tv, ti, n, L, k, cap, Lc, smem, st);
    case 1: return launch<1>(x, m, r, v, i, nullptr, tv, ti, n, L, k, cap, Lc, smem, st);
    case 2: return launch<2>(x, m, r, v, i, nullptr, tv, ti, n, L, k, cap, Lc, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
