// Streaming top-K Pearson for Hopper: each row's K most correlated other rows.
//
// Replaces: src/repro/kernels/topk.py:topk_pearson_pallas (with its
// _merge_topk), the Pallas TPU kernel that walks column tiles of one
// (bm, n) row panel of the correlation matrix and keeps a running (bm, K)
// top-K in its revisited output block, so the (n, n) matrix never exists.
//
// vals[i, :], idx[i, :] = the k best (value, column) pairs of row i, j != i,
// ordered by value descending, then column ascending (lax.top_k's order,
// and a stable descending sort's), with
//
//   value(i, j) = clip(sum_l ((X[i,l] - mu[i]) * rs[i]) * ((X[j,l] - mu[j]) * rs[j]),
//                      -1, 1)
//
// computed with csrc/pearson.cu's own arithmetic: each operand rounded as
// (X - mu) * rs from the same PyTorch row statistics, fmaf in increasing l
// from 0.0f, and pearson.cu's zero-padded FMAs to a multiple of 16 (which
// only turn a -0.0f sum into +0.0f, applied here as one __fadd_rn).  So
// every value is bitwise the (i, j) entry of pearson_cuda(X), and the
// output is bitwise a stable top-k of its rows with the diagonal excluded.
// NaN counts as the largest value, as in a descending torch.sort.
//
// What bounds it on the card: the n (n + 1) / 2 distinct dot products of
// length L are n (n + 1) L = 1.7e10 fp32 operations at the Crop shape
// (n = 19412, L = 46, k = 64), 0.26 ms at 67 TFLOP/s; its bytes (X once,
// the (n, k) values and indices once) take 4 us.  It is bound by
// operations, and this kernel computes both halves of the symmetric
// matrix, twice those.  The tensor cores are not used: their fp32 path is
// TF32, and the values feed discrete TMFG choices.
//
// Design: one block of 256 threads owns R rows (R = 64 at Crop; fewer when
// a large k needs the shared memory).  The block walks the columns in
// tiles of 64 and the series in chunks of Lc <= 128 elements, standardising
// each chunk of its rows and of the tile's columns into shared memory as
// it loads it; when L fits in one chunk (L = 46 at Crop) the rows' chunk is
// loaded once for the whole kernel.  A thread computes one column of the
// tile for R / 4 rows, with float4 loads of the row series (broadcast
// within the warp) and fp32 FMA in registers carried across the chunks, so
// the FMAs still run in increasing l and shared memory does not grow with
// L.  Each row keeps a candidate buffer of `cap` (value, column) pairs and
// a threshold, the k-th best pair kept so far: a tile's value enters the
// buffer only if it beats the threshold (warp ballot, one shared atomic
// per warp and row).  When a buffer could overflow on the next tile, one
// warp sorts it (bitonic, by value desc then column asc), keeps the first
// k and raises the threshold to the k-th.  Columns arrive in increasing
// order, so a later column equal in value to the threshold never beats
// it, which keeps the tie order.  At the end every buffer is sorted once
// more and its first k pairs are written out.  The buffers sit in shared
// memory; where they do not fit (k above about 4000 at L = 46) the wrapper
// passes a scratch buffer in device memory, R * cap pairs per block, and
// the same code runs on it, slower.  Nothing else is written to device
// memory.

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

template <int RQ>   // rows per thread; the block owns R = 4 * RQ rows
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ X, const float* __restrict__ mu,
            const float* __restrict__ rs, float* __restrict__ vals,
            int* __restrict__ idx, float* scratch, int n, int L, int k,
            int cap, int Lc) {
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
  }

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

  for (int r = warp; r < R; r += kWarps) {
    const int gi = i0 + r;
    if (gi >= n) continue;
    for (int s = lane; s < k; s += 32) {
      vals[(int64_t)gi * k + s] = bufv[r * cap + s];
      idx[(int64_t)gi * k + s] = bufi[r * cap + s];
    }
  }
}

template <int RQ>
int launch(const float* X, const float* mu, const float* rs, float* vals,
           int* idx, float* scratch, int n, int L, int k, int cap, int Lc,
           int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<RQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int R = kGroups * RQ;
  topk_kernel<RQ><<<(n + R - 1) / R, kThreads, smem, stream>>>(
      X, mu, rs, vals, idx, scratch, n, L, k, cap, Lc);
  return (int)cudaGetLastError();
}

}  // namespace

// rows_per_block, cap, Lc and smem come from the wrapper's plan
// (kernels/topk.py), which computes smem with the same layout as the
// kernel above.  scratch is null, or 2 * rows_per_block * cap words per
// block for candidate buffers that do not fit in shared memory.
extern "C" int repro_topk(const void* X, const void* mu, const void* rs,
                          void* vals, void* idx, void* scratch, int n, int L,
                          int k, int rows_per_block, int cap, int Lc,
                          int smem, void* stream) {
  if (n <= 1 || L <= 0 || k < 1 || k > n - 1) return (int)cudaErrorInvalidValue;
  if (cap < k + kBN || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (Lc <= 0 || (Lc & 3) != 0) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)X;
  const float* m = (const float*)mu;
  const float* r = (const float*)rs;
  float* v = (float*)vals;
  int* i = (int*)idx;
  float* sc = (float*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows_per_block) {
    case 64: return launch<16>(x, m, r, v, i, sc, n, L, k, cap, Lc, smem, st);
    case 32: return launch<8>(x, m, r, v, i, sc, n, L, k, cap, Lc, smem, st);
    case 16: return launch<4>(x, m, r, v, i, sc, n, L, k, cap, Lc, smem, st);
    case 8: return launch<2>(x, m, r, v, i, sc, n, L, k, cap, Lc, smem, st);
    case 4: return launch<1>(x, m, r, v, i, sc, n, L, k, cap, Lc, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
