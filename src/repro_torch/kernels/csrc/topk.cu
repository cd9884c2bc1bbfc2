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
// from 0.0f over L rounded up to a multiple of 16, the padding zeros (so a
// -0.0f sum turns into +0.0f exactly where pearson.cu's padded panel turns
// it), then the clip.  So every value is bitwise the (i, j) entry of
// pearson_cuda(X), and the output is bitwise a stable top-k of its rows
// with the diagonal excluded.  NaN counts as the largest value, as in a
// descending torch.sort; -0 and +0 tie and fall to the lower column.
//
// What bounds it on the card: the n (n + 1) / 2 distinct dot products of
// length L are n (n + 1) L = 1.7e10 fp32 operations at the Crop shape
// (n = 19412, L = 46, k = 64), 0.26 ms at 67 TFLOP/s; its bytes (X once,
// the (n, k) values and indices once) take 4 us.  It is bound by
// operations, and this kernel computes both halves of the symmetric
// matrix (with L padded to 48), 0.56 ms at the peak.  The tensor cores
// are not used: their fp32 path is TF32, and the values feed discrete
// TMFG choices.
//
// Design.  A probe split of the first design (one column per thread,
// per-row buffers of 256 pairs sorted by a warp when nearly full, one
// block per SM) on an NVIDIA H100 80GB HBM3 at 700 W gave 3.41 ms to its
// FMA loop, 2.27 ms to its filter and 5.41 ms to its sorts, of 11.10 ms
// (tools/approx_kernels_bench.py, PERF.md).  So:
//   * Operands once, coalesced.  A first kernel writes Z = (X - mu) * rs
//     once, l-major and zero-padded, Zt (Lp, Np) (Lp = L up to a multiple
//     of 16, Np = n up to a multiple of 128).  The main kernel brings each
//     16-deep step of a 64-row panel and a 128-column tile in with 16-byte
//     cp.async into a 3-stage ring; no warp waits on a strided load.
//   * A register tile.  256 threads own a 64 x 128 tile; a warp owns 32 x
//     32 of it and a lane 4 x 8 outputs, read by three LDS.128 per l for
//     32 FMAs, each LDS.128 one shared-memory wavefront (8 distinct rows
//     and 4 distinct column chunks per warp).  The step loop runs on
//     across tile boundaries, so the next tile's copies fly under this
//     tile's filter.
//   * The filter from registers.  Each row's threshold (its k-th kept
//     value once it has k, else -inf) sits in shared memory and is read
//     into registers once per tile.  Columns arrive in increasing order,
//     so a value that ties the threshold never beats it: the filter is
//     one unordered compare per value, !(v <= t), true for NaN too.  The
//     four lanes that share a row reserve their pairs' slots with one
//     shared atomic per row and tile, and each lane writes its own.
//   * Compaction without a full sort.  A row keeps its list, the best
//     pairs so far in order, and a staging area of new pairs.  When a
//     row's staging would overflow, the pairs that did not fit stay in
//     their threads' registers, the block merges the staging areas into
//     the lists (every non-empty one where the lists are in shared
//     memory, the half-full ones otherwise), the thresholds rise, and the
//     left-over pairs are filtered again with !(v < t) (a left-over pair
//     may tie the new threshold from a later column of the same tile) and
//     stored.  For k up to 64 a warp merges two rows at once in its
//     registers: each pair becomes a 64-bit key that orders pairs as the
//     contract does and carries the pair's slot (rank_key); the staging's
//     keys (two per lane) are sorted by a bitonic network of shuffles,
//     the best 64 of them and the list's keys come from one max pass and
//     a bitonic merge, and each kept key's slot gives back its pair's own
//     bits.  For larger k the staging is sorted in the warp's shared
//     buffer and each pair of both runs is placed by a binary search in
//     the other.  A k-selection of sorted runs, never a sort of the whole
//     buffer.
//   * Fill the card (stream-K).  Where the lists sit in shared memory (k
//     up to 64 and n up to 2^25: lists and staging of 64 pairs per row,
//     103,168 bytes at k = 64), the grid is two blocks per SM and each
//     block takes an equal run of the (panel, tile) sequence, crossing
//     panel boundaries: one wave, with no idle tail.  Each (block, panel)
//     piece writes its exact top-k of its columns to scratch, and a
//     second kernel of this entry point merges a row's two or three lists
//     by rank (value desc, column asc), which stays bitwise.  Larger k
//     keeps the lists in vals/idx themselves and the staging (1,024 pairs
//     per row) and the merge output in device memory; then a block walks
//     whole panels, two per SM.
//   * Ragged edges: rows past n, columns past n and the diagonal are
//     masked in the few tiles that hold them; the padding of Zt is zero.
//   * A row range (the sharded funnel's row panel, dist/sharding.py
//     topk_pearson_sharded): the panels walk only rows row0 .. row0 +
//     rows - 1, read from their own standardised copy, and the keys run
//     over all n columns, so the range is bitwise those rows of the
//     whole table (repro_topk below).
//
// On an NVIDIA H100 80GB HBM3 at 700 W it takes 2.03-2.04 ms at Crop's
// (19412, 46, 64), 12.7% of the 0.259 ms bound (the first design 11.09-
// 11.10 ms in the same call); of the probes' 1.99 ms, the FMA loop alone
// takes 1.01 ms, the filter 0.43 ms and the merges, with the pieces'
// warm-up, 0.55 ms (tools/approx_kernels_bench.py --probes; PERF.md).  No
// LDL or STL in its SASS at 127 registers (chip_smoke.py).
//
// TOPK_PROBE (tools/approx_kernels_bench.py builds it; never set in the
// package): 1 sums the tile's values into a sink instead of filtering
// them (the FMA loop alone); 2 starts every row's threshold at the value
// in the buffer given by repro_topk_probe_buffer (the final k-th, so only
// the final pairs are kept and nothing is compacted before the end of a
// piece); 3 is the full kernel counting, into that buffer (8 uint64),
// tiles, compaction rounds, rows merged, pairs staged, the SM cycles of
// the rounds, and the sum and the largest of the blocks' cycles.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "standardize.cuh"

#ifndef TOPK_PROBE
#define TOPK_PROBE 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 64;                    // rows per panel
constexpr int kC = 128;                   // columns per tile
constexpr int kBK = 16;                   // series elements per step
constexpr int kStages = 3;                // steps in the cp.async ring
constexpr int kStageFloats = kBK * (kR + kC);
constexpr int kSharedStage = 64;          // staging pairs per row, lists in shared
constexpr int kSharedK = 64;              // the largest k with lists in shared
constexpr int kGlobalStage = 1024;        // staging pairs per row, lists in memory

// (x, j) ranks before (v, i): NaN first, then value desc, then column asc
__device__ __forceinline__ bool better(float x, int j, float v, int i) {
  const bool xn = isnan(x), vn = isnan(v);
  if (xn != vn) return xn;
  if (!xn && x != v) return x > v;
  return j < i;
}

// pairs of the sorted run (av, ai)[0, len) that rank before (x, xi)
__device__ __forceinline__ int count_better(const float* av, const int* ai,
                                            int len, float x, int xi) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(av[mid], ai[mid], x, xi))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Bitonic sort of (bv, bi)[0, size), best first, by one warp; entries from
// cnt to size are set to the sentinel (-inf, INT_MAX) first.
__device__ void sort_run(float* bv, int* bi, int cnt, int size, int lane) {
  for (int p = cnt + lane; p < size; p += 32) {
    bv[p] = -INFINITY;
    bi[p] = INT_MAX;
  }
  __syncwarp();
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int q = lane; q < (size >> 1); q += 32) {
        const int lo = 2 * q - (q & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & len) == 0;   // this run sorts best first
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

// A 64-bit key that orders pairs as better() does, larger first: the
// value's bits mapped so that NaN is largest and -0 ties +0, then the
// column reversed (kMaxCol - col, 25 bits), then the pair's slot (7 bits:
// staging 0..63, list 64..127), which no two keys of a row share and
// which finds the pair's own value bits again.  0 is below every pair
// (the sentinel).
constexpr int kMaxCol = (1 << 25) - 1;    // columns below 2^25 (shared lists)

__device__ __forceinline__ unsigned long long rank_key(float v, int col,
                                                       int slot) {
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = v != v ? 0xffffffffu : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) |
         ((unsigned)(kMaxCol - col) << 7) | (unsigned)slot;
}

// Warp bitonic sort, best first, of 64 keys held two per lane (element
// e = lane + 32 h in K[r][h]), for NR rows at once: their networks are
// independent, so the shuffles of one row hide the latency of the other's.
template <int NR>
__device__ __forceinline__ void warp_sort64(unsigned long long (&K)[NR][2],
                                            int lane) {
#pragma unroll
  for (int len = 2; len <= 64; len <<= 1) {
#pragma unroll
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (stride == 32) {       // len = 64: the lane's own two elements
          const unsigned long long hi = max(K[r][0], K[r][1]);
          K[r][1] = min(K[r][0], K[r][1]);
          K[r][0] = hi;
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = lane + 32 * h;
          const unsigned long long o =
              __shfl_xor_sync(0xffffffffu, K[r][h], stride);
          // a run sorting best first keeps the larger key at its lower index
          const bool keep_max = ((e & len) == 0) == ((e & stride) == 0);
          K[r][h] = keep_max ? max(K[r][h], o) : min(K[r][h], o);
        }
      }
    }
  }
}

// The best 64 keys of two runs sorted best first, A and B (two per lane),
// for NR rows at once: max(A[e], B[63 - e]) is bitonic and holds them; one
// half-cleaner pass per stride sorts it.
template <int NR>
__device__ __forceinline__ void warp_merge64(unsigned long long (&A)[NR][2],
                                             const unsigned long long (&B)[NR][2],
                                             int lane) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      A[r][h] = max(A[r][h], __shfl_sync(0xffffffffu, B[r][1 - h], 31 - lane));
    const unsigned long long hi = max(A[r][0], A[r][1]);
    A[r][1] = min(A[r][0], A[r][1]);
    A[r][0] = hi;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned long long o =
            __shfl_xor_sync(0xffffffffu, A[r][h], stride);
        A[r][h] = (lane & stride) == 0 ? max(A[r][h], o) : min(A[r][h], o);
      }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__host__ __device__ constexpr long long smem_bytes(int shared_lists, int sc,
                                                   int k) {
  return 4LL * (kStages * kStageFloats + 3 * kR) +
         (shared_lists ? 8LL * ((long long)kR * sc + (long long)kR * k)
                       : 8LL * kWarps * kGlobalStage);
}

struct Params {
  const float* zt;          // (Lp, Np) standardised series, l-major
  const float* za;          // (Lp, Na) the rows' own: zt, or a row range's
  float* vals;              // (rows, k) out
  int* idx;
  float* buf_v;             // lists in shared: (G + P, kR, k) pieces;
  int* buf_i;               //   else (G, kR, sc) staging
  int* buf_c;               // lists in shared: (G + P, kR) piece counts
  float* tmp_v;             // lists in memory: (G, kWarps, k) merge output
  int* tmp_i;
  void* probe;              // TOPK_PROBE 2: thresholds; 3: counters
  int n, k, Np, nk;         // nk = Lp / kBK steps per tile
  int row0, rows, Na;       // the rows row0 .. row0 + rows - 1 of the table
  int C, P;                 // column tiles per panel, panels
  long long T;              // tiles, P * C
  int G;                    // blocks
  int sc;                   // staging pairs per row
  int shared_lists;
};

__global__ void __launch_bounds__(kThreads, 2)
topk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int* cnt = reinterpret_cast<int*>(ring + kStages * kStageFloats);  // staged
  int* lcnt = cnt + kR;                                             // listed
  float* thr = reinterpret_cast<float*>(lcnt + kR);                 // k-th
  float* extra = thr + kR;
  const bool sh = p.shared_lists != 0;
  const int sc = p.sc, k = p.k, n = p.n;
  // shared lists: staging, lists and merge output here; else each warp's
  // sort buffer
  float* st_v = extra;
  int* st_i = reinterpret_cast<int*>(st_v + kR * sc);
  float* ls_v = reinterpret_cast<float*>(st_i + kR * sc);
  int* ls_i = reinterpret_cast<int*>(ls_v + kR * k);
  float* so_v = extra;
  int* so_i = reinterpret_cast<int*>(so_v + kWarps * kGlobalStage);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  // a warp owns 32 rows x 32 columns of the tile; a lane 4 rows (r0 + i)
  // and 8 columns (c0 + j, c0 + 16 + j)
  const int r0 = (warp >> 2) * 32 + (lane >> 2) * 4;
  const int c0 = (warp & 3) * 32 + (lane & 3) * 4;
  // TOPK_PROBE == 3: this thread's counts, added to the buffer at the end
  long long block_t0 = 0, round_cycles = 0;
  unsigned long long n_tiles = 0, n_rounds = 0, n_merged = 0, n_staged = 0;
  if (TOPK_PROBE == 3) block_t0 = clock64();

  // the block's tiles: an equal run of the (panel, tile) sequence, or
  // whole panels blockIdx.x, + G, ...; walked by counters, no division
  int ntiles, pan0 = (int)blockIdx.x, col0 = 0;
  if (sh) {
    const long long t0 = (long long)blockIdx.x * p.T / p.G;
    ntiles = (int)((long long)(blockIdx.x + 1) * p.T / p.G - t0);
    pan0 = (int)(t0 / p.C);
    col0 = (int)(t0 - (long long)pan0 * p.C);
  } else {
    ntiles = ((p.P - 1 - (int)blockIdx.x) / p.G + 1) * p.C;
  }
  const int pan_step = sh ? 1 : p.G;

  // per-row storage of the current panel
  auto stage_v = [&](int r) -> float* {
    return sh ? st_v + r * sc : p.buf_v + ((int64_t)blockIdx.x * kR + r) * sc;
  };
  auto stage_i = [&](int r) -> int* {
    return sh ? st_i + r * sc : p.buf_i + ((int64_t)blockIdx.x * kR + r) * sc;
  };

  auto init_rows = [&](int pan) {
    for (int r = t; r < kR; r += kThreads) {
      cnt[r] = 0;
      lcnt[r] = 0;
      float t_ = -INFINITY;
      if (TOPK_PROBE == 2 && pan * kR + r < p.rows)
        t_ = static_cast<const float*>(p.probe)[pan * kR + r];
      thr[r] = t_;
    }
  };

  // Merge the staging of rows ra and rb into their lists (one warp), in
  // shared memory (k up to 64): the keys of both runs of both rows in
  // registers, the staging sorted by warp_sort64, the best k by
  // warp_merge64, then each kept pair read back by its slot.
  auto compact2 = [&](int ra, int rb) {
    const int rr[2] = {ra, rb};
    unsigned long long K[2][2], L[2][2];
    int nc[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = rr[q];
      const int m = min(cnt[r], sc), lc = lcnt[r];
      nc[q] = min(k, lc + m);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h;
        K[q][h] = e < m ? rank_key(st_v[r * sc + e], st_i[r * sc + e], e)
                        : 0ULL;
        L[q][h] = e < lc ? rank_key(ls_v[r * k + e], ls_i[r * k + e], 64 + e)
                         : 0ULL;
      }
    }
    warp_sort64<2>(K, lane);
    warp_merge64<2>(L, K, lane);
    // each kept key's own pair, by its slot, then the new lists
    float v[2][2];
    int c[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = (int)(L[q][h] & 127u), r = rr[q];
        v[q][h] = slot < 64 ? st_v[r * sc + slot] : ls_v[r * k + slot - 64];
        c[q][h] = slot < 64 ? st_i[r * sc + slot] : ls_i[r * k + slot - 64];
      }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = rr[q];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h;
        if (e < nc[q]) {
          ls_v[r * k + e] = v[q][h];
          ls_i[r * k + e] = c[q][h];
        }
      }
      const float kth =
          __shfl_sync(0xffffffffu, k > 32 ? v[q][1] : v[q][0], (k - 1) & 31);
      if (lane == 0) {
        lcnt[r] = nc[q];
        cnt[r] = 0;
        if (nc[q] == k) thr[r] = isnan(kth) ? INFINITY : kth;
      }
    }
    __syncwarp();
  };

  // Lists in memory (k above 64): merge row r's staging into its list (one
  // warp), the staging sorted in the warp's shared buffer, each pair of
  // both runs placed by a binary search in the other.
  auto compact = [&](int pan, int r) {
    const int m = min(cnt[r], sc);
    const int lc = lcnt[r];
    const int nc = min(k, lc + m);
    float* sv = so_v + warp * kGlobalStage;
    int* si = so_i + warp * kGlobalStage;
    {
      const float* gv = stage_v(r);
      const int* gi = stage_i(r);
      for (int q = lane; q < m; q += 32) {
        sv[q] = gv[q];
        si[q] = gi[q];
      }
    }
    int size = 2;
    while (size < m) size <<= 1;
    sort_run(sv, si, m, size, lane);
    float* lv = p.vals + (int64_t)(pan * kR + r) * k;
    int* li = p.idx + (int64_t)(pan * kR + r) * k;
    float* ov = p.tmp_v + ((int64_t)blockIdx.x * kWarps + warp) * k;
    int* oi = p.tmp_i + ((int64_t)blockIdx.x * kWarps + warp) * k;
    for (int q = lane; q < m; q += 32) {
      const float x = sv[q];
      const int xi = si[q];
      const int pos = q + count_better(lv, li, lc, x, xi);
      if (pos < k) {
        ov[pos] = x;
        oi[pos] = xi;
      }
    }
    for (int q = lane; q < lc; q += 32) {
      const float x = lv[q];
      const int xi = li[q];
      const int pos = q + count_better(sv, si, m, x, xi);
      if (pos < k) {
        ov[pos] = x;
        oi[pos] = xi;
      }
    }
    __syncwarp();
    for (int q = lane; q < nc; q += 32) {
      lv[q] = ov[q];
      li[q] = oi[q];
    }
    __syncwarp();
    if (lane == 0) {
      lcnt[r] = nc;
      cnt[r] = 0;
      if (nc == k) {
        const float kth = lv[k - 1];
        thr[r] = isnan(kth) ? INFINITY : kth;
      }
    }
    __syncwarp();
  };

  // the panel's last tile in this block: merge what is staged, and (lists
  // in shared) write each row's list out as this (block, panel) piece
  // every row with staged pairs, or the rows of a round (lists in shared:
  // every row with staged pairs, cheap, and all the thresholds rise
  // together; in memory: the half-full ones)
  auto compact_rows = [&](int pan, bool round) {
    if (sh) {
      for (int r = warp; r < kR; r += 2 * kWarps)
        if (cnt[r] > 0 || cnt[r + kWarps] > 0) {
          if (TOPK_PROBE == 3 && lane == 0) n_merged += 2;
          compact2(r, r + kWarps);
        }
      return;
    }
    for (int r = warp; r < kR; r += kWarps)
      if (cnt[r] >= (round ? sc / 2 : 1)) {
        if (TOPK_PROBE == 3 && lane == 0) ++n_merged;
        compact(pan, r);
      }
  };

  auto flush = [&](int pan) {
    compact_rows(pan, false);
    if (sh) {
      const int64_t seg = (int64_t)blockIdx.x + pan;
      for (int r = warp; r < kR; r += kWarps) {
        const int lc = lcnt[r];
        float* dv = p.buf_v + (seg * kR + r) * k;
        int* di = p.buf_i + (seg * kR + r) * k;
        for (int q = lane; q < lc; q += 32) {
          dv[q] = ls_v[r * k + q];
          di[q] = ls_i[r * k + q];
        }
        if (lane == 0) p.buf_c[seg * kR + r] = lc;
      }
    }
  };

  // one step: 16 series elements of the panel's 64 rows and the tile's
  // 128 columns, 16-byte copies (Zt is padded, so every copy is in bounds)
  const int steps = ntiles * p.nk;
  int ld_kk = 0, ld_pan = pan0, ld_col = col0;   // the next step to copy
  auto load = [&](int s) {
    const int i0 = ld_pan * kR, j0 = ld_col * kC;
    const float* src = p.zt + (int64_t)ld_kk * kBK * p.Np;
    const float* srca = p.za + (int64_t)ld_kk * kBK * p.Na;
    float* As = ring + (s % kStages) * kStageFloats;
    float* Bs = As + kBK * kR;
    if (++ld_kk == p.nk) {
      ld_kk = 0;
      if (++ld_col == p.C) {
        ld_col = 0;
        ld_pan += pan_step;
      }
    }
    {
      const int l = t >> 4, c4 = (t & 15) * 4;
      cp_async16(As + l * kR + c4, srca + (int64_t)l * p.Na + i0 + c4);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = t + q * kThreads;
      const int l = e >> 5, c4 = (e & 31) * 4;
      cp_async16(Bs + l * kC + c4, src + (int64_t)l * p.Np + j0 + c4);
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float sink = 0.0f;

  if (ntiles > 0) init_rows(pan0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  int kk = 0, pan = pan0, col = col0, it = 0;   // the step being computed
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step s landed; the slot of step s - 1 is free
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    cp_async_commit();

    const float* As = ring + (s % kStages) * kStageFloats;
    const float* Bs = As + kBK * kR;
#pragma unroll
    for (int l = 0; l < kBK; ++l) {
      const float4 a = *reinterpret_cast<const float4*>(As + l * kR + r0);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + l * kC + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + l * kC + c0 + 16);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (++kk < p.nk) continue;
    kk = 0;

    // ---- the tile is done: filter its values into the rows' staging ----
    const int i0 = pan * kR, j0 = col * kC;
    if (TOPK_PROBE == 3) ++n_tiles;
    int next_col = col + 1, next_pan = pan;
    if (next_col == p.C) {
      next_col = 0;
      next_pan += pan_step;
    }
    if (TOPK_PROBE == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sink += acc[i][j];
          acc[i][j] = 0.0f;
        }
      pan = next_pan;
      col = next_col;
      ++it;
      continue;
    }
    float4 tq = *reinterpret_cast<const float4*>(thr + r0);
    float th[4] = {tq.x, tq.y, tq.z, tq.w};
    unsigned todo = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!(acc[i][j] <= th[i])) todo |= 1u << (8 * i + j);
    const int g0 = p.row0 + i0;   // the panel's first row in the table
    if (i0 + kR > p.rows || j0 + kC > n || (g0 < j0 + kC && j0 < g0 + kR)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gi = i0 + r0 + i;
          const int gj = j0 + c0 + (j & 3) + 16 * (j >> 2);
          if (gi >= p.rows || gj >= n || p.row0 + gi == gj)
            todo &= ~(1u << (8 * i + j));
        }
    }
    for (;;) {
      // the four lanes of a group share their rows: one atomic per row and
      // group reserves the slots of all their pairs of this tile, each lane
      // writing its own after the group's exclusive prefix
      if (__any_sync(0xffffffffu, todo != 0)) {
        const int lc = lane & 3;
        // the four rows' scans side by side, so their shuffles and
        // atomics overlap
        int pre[4], base[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pre[i] = __popc((todo >> (8 * i)) & 0xffu);
#pragma unroll
        for (int d = 1; d < 4; d <<= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int o = __shfl_up_sync(0xffffffffu, pre[i], d, 4);
            if (lc >= d) pre[i] += o;
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int total = __shfl_sync(0xffffffffu, pre[i], 3, 4);
          base[i] = 0;
          if (lc == 0 && total > 0) base[i] = atomicAdd(&cnt[r0 + i], total);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          base[i] = __shfl_sync(0xffffffffu, base[i], 0, 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned mine = (todo >> (8 * i)) & 0xffu;
          if (!mine) continue;
          int slot = base[i] + pre[i] - __popc(mine);
          float* dv = stage_v(r0 + i);
          int* di = stage_i(r0 + i);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (!(mine & (1u << j))) continue;
            if (slot < sc) {
              if (TOPK_PROBE == 3) ++n_staged;
              float v = acc[i][j];
              v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
              dv[slot] = v;
              di[slot] = j0 + c0 + (j & 3) + 16 * (j >> 2);
              todo &= ~(1u << (8 * i + j));
            }
            ++slot;
          }
        }
      }
      // pairs left over: their rows' staging is full
      if (!__syncthreads_or(todo != 0)) break;
      long long round_t0 = 0;
      if (TOPK_PROBE == 3) round_t0 = clock64();
      compact_rows(pan, true);
      __syncthreads();
      if (TOPK_PROBE == 3) {
        ++n_rounds;
        round_cycles += clock64() - round_t0;
      }
      tq = *reinterpret_cast<const float4*>(thr + r0);
      th[0] = tq.x;
      th[1] = tq.y;
      th[2] = tq.z;
      th[3] = tq.w;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = acc[i][j];
          v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
          if (v < th[i]) todo &= ~(1u << (8 * i + j));
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    if (it + 1 == ntiles || next_pan != pan) {
      flush(pan);
      __syncthreads();
      if (it + 1 < ntiles) init_rows(next_pan);
      // the next barrier (top of the step loop) publishes the reset rows
    }
    pan = next_pan;
    col = next_col;
    ++it;
  }
  cp_async_wait<0>();
  if (TOPK_PROBE == 1 && sink == 1234.5f) p.vals[0] = sink;
  if (TOPK_PROBE == 3) {
    unsigned long long* c = static_cast<unsigned long long*>(p.probe);
    atomicAdd(c + 2, n_merged);
    atomicAdd(c + 3, n_staged);
    if (t == 0) {
      const unsigned long long d = clock64() - block_t0;
      atomicAdd(c, n_tiles);
      atomicAdd(c + 1, n_rounds);
      atomicAdd(c + 4, (unsigned long long)round_cycles);
      atomicAdd(c + 5, d);
      atomicMax(c + 6, d);
    }
  }
}

// Lists in shared memory: row i's output is the rank merge of its pieces,
// one per block that walked part of its panel (one warp per row).
__global__ void __launch_bounds__(256)
merge_kernel(const Params p) {
  const int row = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.rows) return;
  const int pan = row / kR, r = row % kR, k = p.k;
  const long long x0 = (long long)pan * p.C, x1 = x0 + p.C;
  // blocks b whose run [b T / G, (b + 1) T / G) meets [x0, x1)
  const int b_lo = (int)(((x0 + 1) * p.G - 1) / p.T);
  const int b_hi = (int)((x1 * p.G - 1) / p.T);
  for (int a = b_lo; a <= b_hi; ++a) {
    const int64_t sa = ((int64_t)a + pan) * kR + r;
    const int ca = p.buf_c[sa];
    for (int e = lane; e < ca; e += 32) {
      const float x = p.buf_v[sa * k + e];
      const int xi = p.buf_i[sa * k + e];
      int pos = e;
      for (int b = b_lo; b <= b_hi && pos < k; ++b) {
        if (b == a) continue;
        const int64_t sb = ((int64_t)b + pan) * kR + r;
        pos += count_better(p.buf_v + sb * k, p.buf_i + sb * k, p.buf_c[sb],
                            x, xi);
      }
      if (pos < k) {
        p.vals[(int64_t)row * k + pos] = x;
        p.idx[(int64_t)row * k + pos] = xi;
      }
    }
  }
}

#if TOPK_PROBE >= 2
void* g_probe = nullptr;
#endif

}  // namespace

#if TOPK_PROBE >= 2
extern "C" void repro_topk_probe_buffer(void* buf) { g_probe = buf; }
#endif

// The wrapper (kernels/topk.py) plans grid, staging and where the lists
// live with the same formulas and allocates the buffers:
//   zt (Lp, Np) f32; za the same pointer for the whole table, else
//   (Lp, Na) f32 with Na = P * 64 for the row range; lists in shared
//   (shared_lists = 1, sc = 64): buf_v, buf_i (G + P, 64, k), buf_c
//   (G + P, 64), tmp_* unused; lists in memory (sc = 1024): buf_v, buf_i
//   (G, 64, sc), tmp_v, tmp_i (G, 8, k), buf_c unused.  P counts the
//   panels of the range's rows.  smem must be this file's smem_bytes for
//   the plan.
//
// A row range (row0, rows) writes rows row0 .. row0 + rows - 1 of the
// table into vals and idx (rows, k), each row's keys over all n columns.
// The range's rows are standardised into their own copy za, starting at
// column 0, so every 16-byte copy stays aligned whatever row0 is; each
// element is the same fmaf chain on the same operands as in the whole
// table, so a range is bitwise those rows of it.
extern "C" int repro_topk(const void* X, const void* mu, const void* rs,
                          void* vals, void* idx, void* zt, void* za,
                          void* buf_v, void* buf_i, void* buf_c, void* tmp_v,
                          void* tmp_i, int n, int L, int k, int row0,
                          int rows, int grid, int sc, int shared_lists,
                          int smem, void* stream) {
  if (n <= 1 || L <= 0 || k < 1 || k > n - 1) return (int)cudaErrorInvalidValue;
  if (row0 < 0 || rows < 1 || row0 + rows > n) return (int)cudaErrorInvalidValue;
  const bool whole = za == zt;
  if (whole && (row0 != 0 || rows != n)) return (int)cudaErrorInvalidValue;
  const int Lp = (L + kBK - 1) / kBK * kBK;
  const int Np = (n + kC - 1) / kC * kC;
  Params p;
  p.zt = (const float*)zt;
  p.za = (const float*)za;
  p.vals = (float*)vals;
  p.idx = (int*)idx;
  p.buf_v = (float*)buf_v;
  p.buf_i = (int*)buf_i;
  p.buf_c = (int*)buf_c;
  p.tmp_v = (float*)tmp_v;
  p.tmp_i = (int*)tmp_i;
  p.probe = nullptr;
#if TOPK_PROBE >= 2
  p.probe = g_probe;
  if (!p.probe) return (int)cudaErrorInvalidValue;
#endif
  p.n = n;
  p.k = k;
  p.Np = Np;
  p.nk = Lp / kBK;
  p.row0 = row0;
  p.rows = rows;
  p.C = Np / kC;
  p.P = (rows + kR - 1) / kR;
  p.Na = whole ? Np : p.P * kR;
  p.T = (long long)p.P * p.C;
  p.G = grid;
  p.sc = sc;
  p.shared_lists = shared_lists;
  if (shared_lists ? (sc != kSharedStage || k > kSharedK ||
                      n - 1 > kMaxCol || grid < 1 || grid > p.T)
                   : (sc != kGlobalStage || grid < 1 || grid > p.P))
    return (int)cudaErrorInvalidValue;
  if (smem != smem_bytes(shared_lists, sc, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  launch_standardize((const float*)X, (const float*)mu, (const float*)rs,
                     (float*)zt, n, L, Lp, Np, st);
  if (!whole)
    launch_standardize((const float*)X + (int64_t)row0 * L,
                       (const float*)mu + row0, (const float*)rs + row0,
                       (float*)za, rows, L, Lp, p.Na, st);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  topk_kernel<<<grid, kThreads, smem, st>>>(p);
  if (shared_lists && TOPK_PROBE != 1)
    merge_kernel<<<(int)(((int64_t)rows * 32 + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}
