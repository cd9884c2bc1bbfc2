// Flash attention in fp32 for Hopper: causal or sliding-window GQA prefill
// attention with an online softmax, on the CUDA cores.  The bf16 route is
// csrc/flash_attention_wgmma.cu (the tensor cores); this kernel takes fp32
// only, in fp32 on the CUDA cores (no TF32).  On request it also writes
// each row's natural-log logsumexp of its scaled live scores (the lse that
// the fp32 backward, csrc/flash_attention_bwd_tf32x3.cu, reads): (B, H,
// lse_rows(Tq)) with lse_rows(Tq) = Tq rounded up to 64, +inf on a row
// with no live key and on the padding rows; o is the same bit for bit
// with and without it.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas, the
// Pallas TPU kernel that walks (bq, bk) score tiles with the running max,
// denominator and accumulator in VMEM scratch across the sequential kv grid
// axis, skipping tiles outside the causal / window bounds, with the K/V
// BlockSpec indexing head // G so GQA never copies K or V.
//
//   o[b, t, h] = sum_s softmax_s(scale * q[b, t, h] . k[b, s, h // G]) v[b, s, h // G]
//   over the keys s < Tk with (causal: s <= t) and (window > 0: t - s < window)
//
// Semantics kept from the Pallas kernel: q is multiplied by scale as it is
// loaded (the caller passes 1 / sqrt(hd), or 1 for a q it has scaled
// itself); masked scores are the finite NEG = -1e30,
// never -inf, so exp(NEG - NEG) = 1 where a row has seen no live key yet
// and the first live key's correction exp(NEG - m) = 0 wipes that sum
// exactly; the output is acc / max(l, 1e-30).
//
// What bounds it on the card: the work is 4 hd flops per unmasked (q, k)
// pair (QK^T and PV); at the MQA shape (1, 1000, 48, 1, 128) that is
// 12.3 GFLOP against 25 MB of q, k, v and o, so it is bound by
// operations: FMAs on the CUDA cores (67 TFLOP/s peak), 0.184 ms; at
// granite-3-8b's fp32 prefill (1, 1024, 32, 8, 128), 0.128 ms.
//
// Design (a first design of 64 x 64 tiles, K and V taking turns in one
// buffer, four barriers a tile and no copy under an FMA, reached 36% of
// the FMA peak):
//   * A 128-row query tile, at hd up to 128: the rows of a block are Gb
//     heads of one GQA group over P = 128 / Gb positions (Gb = 2 where
//     the group size G is even, else 1), so each K/V tile loaded serves
//     128 rows, and a causal block walks the keys of 64 positions only.
//     The q tile is scaled once as it is loaded.
//   * K and V in separate stages of a 3-slot 16-byte cp.async ring: the
//     64-key tiles come in as halves, K then V, so the next K and V copy
//     under this tile's products.  Rows past Tk are zero-filled by the
//     copy.
//   * Register tiles read by LDS.128.  Lane (rg, kg) of a warp owns rows
//     rg + 4 i (i < 4) of the warp's 16 rows and keys kg + 8 j (j < 8) of
//     the score tile; per 4 of hd it reads 12 float4 for 128 FFMA.
//     The row max and sum are shuffles over the 8 lanes of a row.  A
//     warp's rows are its own, so P goes to a warp-private shared buffer
//     with no extra barrier, and the same lane accumulates its rows'
//     output columns 4 (kg + 8 g) .. + 3 (g < NG = hd / 32 rounded up to
//     1, 2, 4).
//   * Above hd 128 the first design's 64-row tiles stay (flash_kernel_wide
//     below): at hd 256 with a window, 128 rows with 32-key tiles (to fit
//     shared memory) halved the blocks of a small launch, and 64 rows of
//     2 x 8 scores a lane in a 2-slot ring read more shared memory per
//     FMA; both ran slower than it (tools/dense_kernels_bench.py; PERF.md).
//   * The heaviest causal tiles (the last positions) are scheduled first;
//     tiles outside [lo, hi) are skipped by the Pallas kernel's relevance
//     test (causal: k_lo <= q_lo + P - 1; window: k_lo + 63 > q_lo -
//     window).  K and V are read through the (B, T, KV, hd) strides: no
//     copy, no repeat over the group.
// What holds it at about 40% of the FMA peak: each FFMA's operands come
// from shared memory, which delivers 128 bytes a clock to an SM's 128 FMA
// lanes, and a lane reads 12 floats per 32 FFMA of S and 20 per 64 of PV
// (at hd 128), so the loads alone take about 1.4 times the FMAs; larger
// register tiles do not fit the 255 registers or the 227 KB of shared
// memory of one block (tools/dense_kernels_bench.py; PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKJ = kBK / 8;       // keys per lane
constexpr int kPStride = kBK + 8;  // P rows: 4 rg-rows on distinct banks
constexpr float kNeg = -1e30f;

constexpr int kRQ = 4;             // rows per lane
constexpr int kWRows = 4 * kRQ;    // rows per warp
constexpr int kBQ = kWRows * kWarps;   // rows per block
constexpr int kStages = 3;         // K/V halves in the ring

// the saved lse of a row whose online softmax ended at (m, l): +inf where
// no key was live (m still kNeg) and on the padding rows at or past Tq
__device__ __forceinline__ float row_lse(float m, float l, bool in_range) {
  return in_range && m > kNeg ? m + logf(l) : __int_as_float(0x7f800000);
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kBQ + kStages * kBK) * (hd + 4) +
                          (size_t)kWarps * kWRows * kPStride);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// 16 bytes global -> shared; zeros instead where !ok
__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
                                            bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// over the 8 lanes of a row (kg = lane & 7)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// P: positions per block (kBQ or half of it); grid (B * H / Gb,
// ceil(Tq / P)) with Gb = kBQ / P heads per block
template <int NG>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int KV, int Tq, int Tk, int hd,
             int causal, int window, float scale, int P) {
  constexpr int RQ = kRQ;
  constexpr int BK = kBK;
  constexpr int STAGES = kStages;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = hd + 4;
  float* q_s = smem;                              // (BQ, hd + 4)
  float* ring = q_s + kBQ * stride;             // STAGES x (BK, hd + 4)
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int rg = lane >> 3, kg = lane & 7;
  float* p_s = ring + STAGES * BK * stride +      // this warp's P rows
               warp * kWRows * kPStride;

  const int G = H / KV, Gb = kBQ / P, chunks = G / Gb;
  const int hc = blockIdx.x % chunks;
  const int bk = blockIdx.x / chunks;
  const int kvh = bk % KV, b = bk / KV;
  const int h0 = kvh * G + hc * Gb;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heavy causal tiles first
  const int q_lo = qt * P;
  const int cpr = hd >> 2;                     // float4 chunks per row

  // the q tile: row r is head h0 + r / P at position q_lo + r % P, times
  // scale; rows at or past Tq are zero
  for (int g = t; g < kBQ * cpr; g += kThreads) {
    const int r = g / cpr;
    const int c = (g - r * cpr) << 2;
    const int pos = q_lo + r % P;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < Tq) {
      x = load4(q + (((int64_t)b * Tq + pos) * H + h0 + r / P) * hd + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    store4(q_s + r * stride + c, x);
  }

  int lrow[RQ], qpos[RQ];
  float m[RQ], l[RQ], acc[RQ][NG * 4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    lrow[i] = warp * kWRows + rg + 4 * i;
    qpos[i] = q_lo + lrow[i] % P;
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Tk + BK - 1) / BK;
  int hi = nk;
  if (causal) hi = min(nk, (q_lo + P - 1) / BK + 1);
  int lo = 0;
  if (window > 0) lo = max(0, (q_lo - window + 1) / BK);
  const int steps = 2 * max(hi - lo, 0);       // K, V halves of each tile
  const int64_t kv_row0 = (int64_t)b * Tk * KV + kvh;

  auto load_half = [&](int s) {
    const int key0 = (lo + (s >> 1)) * BK;
    const float* src = (s & 1) ? v : k;
    float* dst = ring + (s % STAGES) * BK * stride;
    for (int g = t; g < BK * cpr; g += kThreads) {
      const int r = g / cpr;
      const int c = (g - r * cpr) << 2;
      const bool ok = key0 + r < Tk;
      cp_async16z(dst + r * stride + c,
                  ok ? src + (kv_row0 + (int64_t)(key0 + r) * KV) * hd + c
                     : src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_half(s);
    cp_async_commit();
  }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // half s landed; the slot of half s - 1 is free
    if (s + STAGES - 1 < steps) load_half(s + STAGES - 1);
    cp_async_commit();
    const float* buf = ring + (s % STAGES) * BK * stride;

    if ((s & 1) == 0) {
      // ---- S = q K^T, the online softmax, P to this warp's buffer ----
      const int k_lo = (lo + (s >> 1)) * BK;
      float sc[RQ][kKJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < kKJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < hd; d += 4) {
        float4 qa[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) qa[i] = load4(q_s + lrow[i] * stride + d);
#pragma unroll
        for (int j = 0; j < kKJ; ++j) {
          const float4 kb = load4(buf + (kg + 8 * j) * stride + d);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            sc[i][j] = fmaf(qa[i].x, kb.x, sc[i][j]);
            sc[i][j] = fmaf(qa[i].y, kb.y, sc[i][j]);
            sc[i][j] = fmaf(qa[i].z, kb.z, sc[i][j]);
            sc[i][j] = fmaf(qa[i].w, kb.w, sc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qi = qpos[i];
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < kKJ; ++j) {
          const int ki = k_lo + kg + 8 * j;
          bool live = ki < Tk;
          if (causal) live = live && qi >= ki;
          if (window > 0) live = live && (qi - ki) < window;
          if (!live) sc[i][j] = kNeg;
          mx = fmaxf(mx, sc[i][j]);
        }
        const float m_new = fmaxf(m[i], row_max(mx));
        float sum = 0.f;
        float* prow = p_s + (rg + 4 * i) * kPStride + kg;
#pragma unroll
        for (int j = 0; j < kKJ; ++j) {
          const float p = expf(sc[i][j] - m_new);
          sum += p;
          prow[8 * j] = p;
        }
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + row_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NG * 4; ++c) acc[i][c] *= corr;
      }
    } else {
      // ---- O += P V: P from this warp's buffer (written by its own lanes
      // in the previous half, before this half's barrier) ----
#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        float4 pa[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          pa[i] = load4(p_s + (rg + 4 * i) * kPStride + kk);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int c = (kg + 8 * g) << 2;
          if (c < hd) {
            const float4 v0 = load4(buf + (kk + 0) * stride + c);
            const float4 v1 = load4(buf + (kk + 1) * stride + c);
            const float4 v2 = load4(buf + (kk + 2) * stride + c);
            const float4 v3 = load4(buf + (kk + 3) * stride + c);
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
              float* a = acc[i] + 4 * g;
              a[0] = fmaf(pa[i].x, v0.x, a[0]);
              a[1] = fmaf(pa[i].x, v0.y, a[1]);
              a[2] = fmaf(pa[i].x, v0.z, a[2]);
              a[3] = fmaf(pa[i].x, v0.w, a[3]);
              a[0] = fmaf(pa[i].y, v1.x, a[0]);
              a[1] = fmaf(pa[i].y, v1.y, a[1]);
              a[2] = fmaf(pa[i].y, v1.z, a[2]);
              a[3] = fmaf(pa[i].y, v1.w, a[3]);
              a[0] = fmaf(pa[i].z, v2.x, a[0]);
              a[1] = fmaf(pa[i].z, v2.y, a[1]);
              a[2] = fmaf(pa[i].z, v2.z, a[2]);
              a[3] = fmaf(pa[i].z, v2.w, a[3]);
              a[0] = fmaf(pa[i].w, v3.x, a[0]);
              a[1] = fmaf(pa[i].w, v3.y, a[1]);
              a[2] = fmaf(pa[i].w, v3.z, a[2]);
              a[3] = fmaf(pa[i].w, v3.w, a[3]);
            }
          }
        }
      }
    }
  }

  if (lse != nullptr && kg == 0) {
    const int ldr = (Tq + 63) / 64 * 64;
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      if (qpos[i] < ldr)
        lse[((int64_t)b * H + h0 + lrow[i] / P) * ldr + qpos[i]] =
            row_lse(m[i], l[i], qpos[i] < Tq);
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int pos = qpos[i];
    if (pos >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (((int64_t)b * Tq + pos) * H + h0 + lrow[i] / P) * hd;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = (kg + 8 * g) << 2;
      if (c < hd) {
        const float* a = acc[i] + 4 * g;
        store4(orow + c,
               make_float4(a[0] / den, a[1] / den, a[2] / den, a[3] / den));
      }
    }
  }
}

template <int NG>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Tq, int Tk, int H, int KV, int hd, int causal,
           int window, float scale, cudaStream_t stream) {
  // two heads of a group per block where the group size allows
  const int P = (H / KV) % 2 == 0 ? kBQ / 2 : kBQ;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H / (kBQ / P), (Tq + P - 1) / P);
  flash_kernel<NG><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, H, KV, Tq, Tk, hd, causal, window, scale, P);
  return (int)cudaGetLastError();
}

// ---- hd above 128: the first design's tiling, which stays the faster one
// there (tools/dense_kernels_bench.py; PERF.md).  64 query rows of one
// head a block, thread (ty, tx) of a 16 x 16 grid owning rows ty + 16 i
// and keys tx + 16 j (i, j < 4) of the score tile and the float4 output
// columns tx + 16 g (g < NG = ceil(hd / 64)); each 64-key tile of K, then
// of V, is loaded into one shared buffer, so a block holds q, one K/V
// tile and P: 150 KB at hd 256. ----
constexpr int kWideRows = 64;
constexpr int kWidePStride = kBK + 4;

// rows [t0, t0 + 64) of one head of a (B, T, nh, hd) tensor into dst
// (row stride hd + 4) times mul; rows at or past T are zero
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row0, int t0, int T_,
                                          int nh, int hd, float mul) {
  const int groups = hd >> 2;
  for (int g = threadIdx.x; g < kWideRows * groups; g += kThreads) {
    const int r = g / groups;
    const int c = (g - r * groups) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T_) {
      x = load4(src + (row0 + (int64_t)(t0 + r) * nh) * hd + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    store4(dst + r * (hd + 4) + c, x);
  }
}

// over the 16 lanes of a row group (tx = lane & 15)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int NG>
__global__ void __launch_bounds__(kThreads)
flash_kernel_wide(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int H, int KV, int Tq, int Tk,
                  int hd, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = hd + 4;
  float* q_s = smem;                        // (64, hd + 4)
  float* kv_s = q_s + kWideRows * stride;   // (64, hd + 4): K, then V
  float* p_s = kv_s + kBK * stride;         // (64, 68)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heavy causal tiles first
  const int q_lo = qt * kWideRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(q_s, q, (int64_t)b * Tq * H + h, q_lo, Tq, H, hd, scale);

  float m[4], l[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Tk + kBK - 1) / kBK;
  int hi = nk;
  if (causal) hi = min(nk, (q_lo + kWideRows + kBK - 1) / kBK);
  int lo = 0;
  if (window > 0) lo = max(0, (q_lo - window + 1) / kBK);
  const int64_t kv_row0 = (int64_t)b * Tk * KV + kvh;

  for (int kt = lo; kt < hi; ++kt) {
    const int k_lo = kt * kBK;
    __syncthreads();   // the previous tile's PV is done with kv_s and p_s
    load_tile(kv_s, k, kv_row0, k_lo, Tk, KV, hd, 1.f);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = load4(q_s + (ty + 16 * i) * stride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = load4(kv_s + (tx + 16 * j) * stride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i].x, ka[j].x, sc[i][j]);
          sc[i][j] = fmaf(qa[i].y, ka[j].y, sc[i][j]);
          sc[i][j] = fmaf(qa[i].z, ka[j].z, sc[i][j]);
          sc[i][j] = fmaf(qa[i].w, ka[j].w, sc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_lo + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k_lo + tx + 16 * j;
        bool live = ki < Tk;
        if (causal) live = live && qi >= ki;
        if (window > 0) live = live && (qi - ki) < window;
        if (!live) sc[i][j] = kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * kWidePStride + tx + 16 * j] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();   // every thread is done reading K
    load_tile(kv_s, v, kv_row0, k_lo, Tk, KV, hd, 1.f);
    __syncthreads();   // V and P are in shared memory

    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = load4(p_s + (ty + 16 * i) * kWidePStride + j);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = (tx + 16 * g) << 2;
        if (c < hd) {
          const float4 v0 = load4(kv_s + (j + 0) * stride + c);
          const float4 v1 = load4(kv_s + (j + 1) * stride + c);
          const float4 v2 = load4(kv_s + (j + 2) * stride + c);
          const float4 v3 = load4(kv_s + (j + 3) * stride + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc[i] + 4 * g;
            a[0] = fmaf(pa[i].x, v0.x, a[0]);
            a[1] = fmaf(pa[i].x, v0.y, a[1]);
            a[2] = fmaf(pa[i].x, v0.z, a[2]);
            a[3] = fmaf(pa[i].x, v0.w, a[3]);
            a[0] = fmaf(pa[i].y, v1.x, a[0]);
            a[1] = fmaf(pa[i].y, v1.y, a[1]);
            a[2] = fmaf(pa[i].y, v1.z, a[2]);
            a[3] = fmaf(pa[i].y, v1.w, a[3]);
            a[0] = fmaf(pa[i].z, v2.x, a[0]);
            a[1] = fmaf(pa[i].z, v2.y, a[1]);
            a[2] = fmaf(pa[i].z, v2.z, a[2]);
            a[3] = fmaf(pa[i].z, v2.w, a[3]);
            a[0] = fmaf(pa[i].w, v3.x, a[0]);
            a[1] = fmaf(pa[i].w, v3.y, a[1]);
            a[2] = fmaf(pa[i].w, v3.z, a[2]);
            a[3] = fmaf(pa[i].w, v3.w, a[3]);
          }
        }
      }
    }
  }

  if (lse != nullptr && tx == 0) {
    const int ldr = (Tq + 63) / 64 * 64;   // 64-row tiles: every row < ldr
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q_lo + ty + 16 * i;
      lse[(int64_t)bh * ldr + t] = row_lse(m[i], l[i], t < Tq);
    }
  }
  const int64_t o_row0 = (int64_t)b * Tq * H + h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q_lo + ty + 16 * i;
    if (t >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = (tx + 16 * g) << 2;
      if (c < hd) {
        const float* a = acc[i] + 4 * g;
        store4(o + (o_row0 + (int64_t)t * H) * hd + c,
               make_float4(a[0] / den, a[1] / den, a[2] / den, a[3] / den));
      }
    }
  }
}

template <int NG>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Tq, int Tk, int H, int KV, int hd,
                int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kWideRows + kBK) * (hd + 4) +
                                       kWideRows * kWidePStride);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_wide<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + kWideRows - 1) / kWideRows);
  flash_kernel_wide<NG><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, H, KV, Tq, Tk, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, hd), k and v (B, Tk, KV, hd) and o (B, Tq, H, hd), fp32,
// contiguous and 16-byte aligned; hd a multiple of 8 up to 256; H a
// multiple of KV; B * H and the query tiles within the grid's limits
// (checked by the wrapper, whose plan() repeats the tiling chosen here).
// lse: 0, or (B, H, lse_rows(Tq)) fp32 for each row's logsumexp.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int Tq, int Tk, int H, int KV,
                                     int hd, int causal, int window,
                                     float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      hd <= 0 || hd > 256 || hd % 8 != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 32)
    return launch<1>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal, window,
                     scale, s);
  if (hd <= 64)
    return launch<2>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal, window,
                     scale, s);
  if (hd <= 128)
    return launch<4>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal, window,
                     scale, s);
  if (hd <= 192)
    return launch_wide<3>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal,
                          window, scale, s);
  return launch_wide<4>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal, window,
                        scale, s);
}
