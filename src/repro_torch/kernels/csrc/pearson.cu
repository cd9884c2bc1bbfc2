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
// the write.  The tensor cores are not used on purpose: their fp32 path
// is TF32, which keeps about three decimal digits, and the similarity
// feeds discrete TMFG decisions.
//
// Design (a first design computed both halves from a panel it
// standardised again in every block, read one float at a time from
// shared memory, and wrote one scalar at a time: 1.875 ms, 0.8 TB/s):
//   * Standardise once.  A first kernel (standardize.cuh, shared with
//     topk.cu) writes Zt = ((X - mu) * rs)^T, l-major, zero-padded to
//     Lp = L rounded up to 16 and to Np columns.
//   * Half the products.  Only the tiles (bi <= bj) are computed, on a
//     persistent grid of two blocks per SM; block b takes tiles b, b + G,
//     b + 2G, ... of an order of 16 x 16 super-tiles, walked by counters.
//     The 16-deep steps of the two 128-column panels come in by 16-byte
//     cp.async through a 2-stage ring that runs on across tiles.
//   * An 8 x 8 register tile.  256 threads; a warp owns 16 whole rows of
//     the 128 x 128 tile, a lane rows {r0 + q, r0 + 8 + q} and columns
//     {c0 + e, c0 + 64 + e} (q, e < 4), read per l by four LDS.128 for 64
//     FFMA.
//   * Whole 32-byte sectors.  Stores that cover only part of a sector
//     cost far more than their bytes: on an NVIDIA H100 80GB HBM3 at 700
//     W a write of the output in 128 x 128 tiles ran at 2.95-3.03 TB/s
//     where every row starts on a sector and at 1.61-2.28 TB/s at Crop's
//     n (19412 % 8 == 4: every other row starts 16 bytes into a sector;
//     tools/dense_kernels_bench.py).  So a tile computes 128 x 128 values
//     but owns only own = 124 rows of each copy (120 where n % 4 != 0),
//     and in each row it owns the columns from the first sector boundary
//     at or after its first column to the first at or after its own-th:
//     every store covers whole sectors but at a row's two ends.  The 6.6%
//     of products computed twice are the price.
//   * Both copies from one accumulator, so the output is bitwise
//     symmetric by construction (a diagonal tile is computed whole and is
//     symmetric because fmaf's product commutes).  A tile's own rows go
//     straight from the registers as st.global.cs.v4, each lane's float4
//     moved one lane over by a shuffle in the rows 16 bytes off their
//     sectors; its columns, as rows of the transposed copy, go through a
//     swizzled shared-memory tile, one warp per row.  Where n % 4 != 0
//     (rows not 16-byte aligned) a second template instance writes both
//     copies through shared memory, still as float4s from each row's
//     first sector boundary on (the row's first and last floats one by
//     one).  4-byte stores, 32 consecutive floats a warp, ran slower
//     in both instances, and tiles owning all 128 columns slower still
//     at Crop's n (tools/dense_kernels_bench.py; PERF.md).
// Arithmetic: acc = 0, then acc = fmaf(Z[i,l], Z[j,l], acc) for l = 0 ...
// Lp - 1 in increasing order over the zero padding (so a -0.0f sum turns
// into +0.0f exactly where the first design's padded panels turned it),
// then the clip, which passes NaN through as torch.clamp does.  topk.cu
// computes every value with the same sequence, so its values are bitwise
// this kernel's, and the output is bitwise the first design's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "standardize.cuh"

namespace {

constexpr int kT = 128;                       // computed tile side
constexpr int kBK = 16;                       // series elements per step
constexpr int kStages = 2;                    // steps in the cp.async ring
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageFloats = kBK * 2 * kT;    // the row and column panels
constexpr int kSmemBytes = (kStages * kStageFloats + kT * kT) * 4;
constexpr int kBlocksPerSM = 2;
constexpr int kS = 16;                        // tiles per super-tile side

// Owned tile side: a tile computes kT x kT values and owns this many rows
// of each copy; a row's owned columns start at a 32-byte sector boundary
// of that row in memory, at most 4 (16-byte rows) or 7 floats past the
// tile's first column, and end at most as far past its own-th, so they
// stay inside the computed kT.
template <bool kVec>
__host__ __device__ constexpr int own_side() {
  return kVec ? kT - 4 : kT - 8;
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

// The tile order: super-tiles of kS x kS tiles, the upper triangle of
// them row-major (si <= sj), and in each its tiles row-major, only those
// with bi <= bj in a diagonal one.  Blocks take every G-th tile of this
// order, so the tiles in flight at one time form about one super-tile,
// whose direct and transposed stores both land as runs of kS x 512 B.
struct Walk {
  int si, sj, idx;   // super-tile, and the tile's place in it
};

__device__ __forceinline__ int super_tiles(int si, int sj, int nb) {
  const int h = min(kS, nb - si * kS), w = min(kS, nb - sj * kS);
  return si == sj ? h * (h + 1) / 2 : h * w;
}

// Move by `by` tiles; si reaches ns past the last tile.
__device__ __forceinline__ void advance(Walk& p, int by, int nb, int ns) {
  p.idx += by;
  while (p.si < ns) {
    const int c = super_tiles(p.si, p.sj, nb);
    if (p.idx < c) break;
    p.idx -= c;
    if (++p.sj == ns) p.sj = ++p.si;
  }
}

__device__ __forceinline__ void tile_of(const Walk& p, int nb, int& bi,
                                        int& bj) {
  const int h = min(kS, nb - p.si * kS), w = min(kS, nb - p.sj * kS);
  if (p.si != p.sj) {
    bi = p.si * kS + p.idx / w;
    bj = p.sj * kS + p.idx % w;
    return;
  }
  int r = 0, idx = p.idx;
  while (idx >= h - r) {
    idx -= h - r;
    ++r;
  }
  bi = p.si * kS + r;
  bj = bi + idx;
}

__device__ __forceinline__ float clip(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

// Floats from column c of row g of out (n, n) to the next 32-byte sector
// boundary: 0 .. 7 (0 or 4 where n % 4 == 0).
__device__ __forceinline__ int phase(int g, int c, int n) {
  return (int)((8 - (((int64_t)g * n + c) & 7)) & 7);
}

// The staging tile (kT x kT floats, no padding): the 16-byte chunk q of
// row r sits at chunk q ^ ((r >> 2) & 7), so the float4 writes of a warp
// (16 rows 4 apart, or 2 chunks of 16 rows) and the reads of one row both
// spread over all 32 banks.
__device__ __forceinline__ int staged(int r, int c) {
  return r * kT + ((((c >> 2) ^ (r >> 2)) & 7) | ((c >> 2) & ~7)) * 4 +
         (c & 3);
}

// Write the owned part of the staged tile: rows g0 .. g0 + own - 1 of out
// (below n), each from the sector boundary at or after column c0 (column
// 0 for the first tile of a row) to the one at or after c0 + own (or n),
// one warp per row.  The lanes store float4s from the sector boundary on,
// so every store covers whole sectors; a row's first floats (before its
// first boundary) and last ones (past its last) go one by one.  A warp
// reads four rows from shared memory before it stores them.
template <bool kVec>
__device__ __forceinline__ void write_rows(const float* stage,
                                           float* __restrict__ out, int n,
                                           int g0, int c0, bool first,
                                           int warp, int lane) {
  constexpr int own = own_side<kVec>();
  constexpr int kU = 4;
  for (int r1 = warp; r1 < own; r1 += kU * kWarps) {
    float4 v[kU];
    int c[kU], s1[kU], head[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r1 + u * kWarps, g = g0 + r;
      const bool live = r < own && g < n;
      const int ph = phase(g, c0, n);
      s1[u] = live ? min(own + phase(g, c0 + own, n), n - c0) : 0;
      head[u] = first ? min(ph, s1[u]) : 0;
      c[u] = ph + 4 * lane;
      if (c[u] < s1[u]) {
        if (kVec) {
          v[u] = *reinterpret_cast<const float4*>(stage + staged(r, c[u]));
        } else {
          v[u] = make_float4(stage[staged(r, c[u])],
                             stage[staged(r, c[u] + 1)],
                             stage[staged(r, c[u] + 2)],
                             stage[staged(r, c[u] + 3)]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r1 + u * kWarps;
      float* row = out + (int64_t)(g0 + r) * n + c0;
      if (lane < head[u]) __stcs(row + lane, stage[staged(r, lane)]);
      if (c[u] + 4 <= s1[u]) {
        __stcs(reinterpret_cast<float4*>(row + c[u]), v[u]);
      } else if (!kVec && c[u] < s1[u]) {
        const float w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c[u] + e < s1[u]) __stcs(row + c[u] + e, w[e]);
      }
    }
  }
}

// kVec: out's rows are 16-byte aligned (n % 4 == 0): 16-byte stores.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
pearson_kernel(const float* __restrict__ zt, float* __restrict__ out, int n,
               int Np, int nk, int nb) {
  constexpr int own = own_side<kVec>();
  extern __shared__ __align__(16) float ring[];
  float* stage = ring + kStages * kStageFloats;   // (kT, kT), swizzled
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  // a warp owns 16 whole rows of the tile; lane (rg, cg) rows r0 + q and
  // r0 + 8 + q, columns c0 + e and c0 + 64 + e (q, e < 4): acc[4 s + q]
  // [4 h + e] is (r0 + 8 s + q, c0 + 64 h + e)
  const int cg = lane & 15;
  const int r0 = warp * 16 + (lane >> 4) * 4;
  const int c0 = cg * 4;
  const int G = gridDim.x;

  // this block's first tile, and how many it takes
  const int ns = (nb + kS - 1) / kS;
  Walk cur = {0, 0, 0};
  advance(cur, blockIdx.x, nb, ns);
  const long long T = (long long)nb * (nb + 1) / 2;
  const int ntiles = (int)((T - 1 - blockIdx.x) / G + 1);
  const int steps = ntiles * nk;

  int ld_kk = 0, ld_bi, ld_bj;                // the next step to copy
  Walk ld = cur;
  tile_of(ld, nb, ld_bi, ld_bj);
  auto load = [&](int s) {
    const float* src = zt + (int64_t)ld_kk * kBK * Np;
    const int i0 = ld_bi * own, j0 = ld_bj * own;
    float* As = ring + (s % kStages) * kStageFloats;
    float* Bs = As + kBK * kT;
    if (++ld_kk == nk) {
      ld_kk = 0;
      advance(ld, G, nb, ns);
      if (ld.si < ns) tile_of(ld, nb, ld_bi, ld_bj);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = t + q * kThreads;
      const int l = e >> 5, c4 = (e & 31) * 4;
      cp_async16(As + l * kT + c4, src + (int64_t)l * Np + i0 + c4);
      cp_async16(Bs + l * kT + c4, src + (int64_t)l * Np + j0 + c4);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  int kk = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step s landed; the slot of step s - 1 is free
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    cp_async_commit();

    const float* As = ring + (s % kStages) * kStageFloats;
    const float* Bs = As + kBK * kT;
#pragma unroll
    for (int l = 0; l < kBK; ++l) {
      const float* Al = As + l * kT;
      const float* Bl = Bs + l * kT;
      const float4 a0 = *reinterpret_cast<const float4*>(Al + r0);
      const float4 a1 = *reinterpret_cast<const float4*>(Al + r0 + 8);
      const float4 b0 = *reinterpret_cast<const float4*>(Bl + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(Bl + c0 + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (++kk < nk) continue;
    kk = 0;

    // ---- the tile is done: clip it, write its owned rows, then stage it
    // transposed and (off the diagonal) write its owned columns as rows ----
    int bi, bj;
    tile_of(cur, nb, bi, bj);
    const int i0 = bi * own, j0 = bj * own;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = clip(acc[i][j]);
    if (kVec) {
      // Straight from the registers.  A row whose memory is 16 bytes off
      // its sectors at j0 (phase 4; the two rows of one store share it, n
      // being even) shifts each lane's float4 by one lane, so every store
      // of the warp covers whole sectors; the row's first 4 floats (when
      // it starts at column 0) and the lane past the tile go alone.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + (i & 3) + 8 * (i >> 2), g = i0 + r;
        const bool live = r < own && g < n;
        const int ph = phase(g, j0, n);
        const int s0 = bj == 0 ? 0 : ph;
        const int s1 = live ? min(own + phase(g, j0 + own, n), n - j0) : 0;
        float* row = out + (int64_t)g * n + j0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                 acc[i][4 * h + 2], acc[i][4 * h + 3]);
          int c = c0 + 64 * h;
          if (ph != 0) {
            if (h == 0 && cg == 0 && s0 == 0 && s1 >= 4)
              __stcs(reinterpret_cast<float4*>(row), v);
            float w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float down =
                  __shfl_down_sync(0xffffffffu, acc[i][4 * h + e], 1, 16);
              const float wrap = __shfl_sync(
                  0xffffffffu, acc[i][(4 * h + 4 + e) & 7], 0, 16);
              w[e] = cg == 15 ? wrap : down;
            }
            v = make_float4(w[0], w[1], w[2], w[3]);
            c += 4;
          }
          if (c >= s0 && c + 4 <= s1)
            __stcs(reinterpret_cast<float4*>(row + c), v);
        }
      }
    } else {
      __syncthreads();   // the last tile's rows are out of the staging
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(
              stage + staged(r0 + (i & 3) + 8 * (i >> 2), c0 + 64 * h)) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
      __syncthreads();
      write_rows<kVec>(stage, out, n, i0, j0, bj == 0, warp, lane);
    }
    if (bi != bj) {
      __syncthreads();   // the last copy out of the staging is done
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
          *reinterpret_cast<float4*>(
              stage + staged(c0 + (j & 3) + 64 * (j >> 2), r0 + 8 * s2)) =
              make_float4(acc[4 * s2][j], acc[4 * s2 + 1][j],
                          acc[4 * s2 + 2][j], acc[4 * s2 + 3][j]);
      __syncthreads();
      write_rows<kVec>(stage, out, n, j0, i0, bi == 0, warp, lane);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    advance(cur, G, nb, ns);
  }
}

template <bool kVec>
int launch_main(const float* zt, float* out, int n, int Np, int nk, int nb,
                int grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      pearson_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  pearson_kernel<kVec><<<grid, kThreads, kSmemBytes, st>>>(zt, out, n, Np,
                                                           nk, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// X (n, L), mu and rs (n,), out (n, n), fp32 and contiguous; zt the
// scratch for the standardised series, (Lp, Np) floats with Lp = L
// rounded up to 16 and Np = (nb - 1) own + 128 rounded up to 32, which
// the caller passes and this entry refuses unless they are its own
// (kernels/pearson.py:plan repeats the formulas).  Two kernels on the
// stream: the standardise pass, then the tiles on a grid of two blocks
// per SM.
extern "C" int repro_pearson(const void* X, const void* mu, const void* rs,
                             void* zt, void* out, int n, int L, int Lp,
                             int Np, void* stream) {
  if (n <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int own = n % 4 == 0 ? own_side<true>() : own_side<false>();
  const int nb = (n + own - 1) / own;
  if (Lp != (L + kBK - 1) / kBK * kBK ||
      Np != ((nb - 1) * own + kT + 31) / 32 * 32)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)nb * (nb + 1) / 2;
  const int grid = (int)(tiles < (long long)kBlocksPerSM * sms
                             ? tiles : (long long)kBlocksPerSM * sms);
  cudaStream_t st = (cudaStream_t)stream;
  launch_standardize((const float*)X, (const float*)mu, (const float*)rs,
                     (float*)zt, n, L, Lp, Np, st);
  if (n % 4 == 0)
    return launch_main<true>((const float*)zt, (float*)out, n, Np, Lp / kBK,
                             nb, grid, st);
  return launch_main<false>((const float*)zt, (float*)out, n, Np, Lp / kBK,
                            nb, grid, st);
}
