// The backward of the port's flash attention on Hopper: dQ, dK and dV of
// causal, sliding-window or bidirectional GQA attention, in fp32 on the
// CUDA cores.  It is no route: bf16 takes the tensor-core kernels of
// csrc/flash_attention_bwd_wgmma.cu and csrc/flash_attention_bwd_wgmma_wide.cu,
// fp32 those of csrc/flash_attention_bwd_tf32x3.cu
// (kernels/flash_attention.py:bwd_route).  It runs only when forced
// (bwd_launches(..., route="cuda_core")), at either dtype and any hd, as
// the old side of an A/B against them on the card.
//
// Replaces no TPU kernel: the Pallas kernel it differentiates
// (src/repro/kernels/flash_attention.py:flash_attention_pallas) is
// forward-only, and the JAX package trains by XLA's autodiff of the jnp
// _flash (src/repro/models/attention.py).  On the card the port's
// attention is a hand-written kernel (flash_attention.cu in fp32,
// flash_attention_wgmma.cu in bf16), so its gradient is one too, bound
// through a torch.autograd.Function in kernels/ops.py.
//
//   s[t, j] = scale * q[b, t, h] . k[b, j, h / G]   (masked to -1e30)
//   p = softmax_j(s),  o = p v
//   D[t] = sum_c dO[t, c] O[t, c]
//   dV[j] = sum_{h in group, t} p[t, j] dO[t]
//   dS[t, j] = p[t, j] (dO[t] . v[j] - D[t])
//   dQ[t] = scale * sum_j dS[t, j] k[j]
//   dK[j] = scale * sum_{h in group, t} dS[t, j] q[t]
// over the keys j < Tk with (causal: j <= t) and (window > 0: t - j <
// window), the forward's masks, positions being the absolute indices.
//
// Three launches, deterministic, no atomics (a step is bitwise repeatable
// on one card):
//   (a) rows: one block per (b, h, 64-query tile).  It recomputes each
//       row's max m and sum l over its live keys, walking the key tiles
//       the forward's relevance test keeps, and writes lse = m + log l
//       (B, H, Tq) fp32, and D (B, H, Tq) fp32 (PR 24's design, kept as
//       it was: it takes no saved lse).
//   (b) dK, dV: one block per (b, KV head, key tile).  It loops over the
//       G heads of the group and the query tiles that can see the tile
//       (the causal lower bound, the window's upper bound), recomputes
//       p = exp(s - lse) and accumulates dV += p^T dO and dK += dS^T q in
//       registers.
//   (c) dQ: one block per (b, h, query tile), heaviest causal tiles
//       first; it loops over the live key tiles and accumulates dQ += dS k.
//
// What bounds it on the card: 10 hd flops per unmasked (q, k) pair and
// head (QK^T, dO V^T, P^T dO, dS^T Q and dS K) against the bytes of q, k,
// v, o and dO read once and dQ, dK and dV written once; at granite-3-8b's
// training shape (1, 4096, 32, 8, 128), causal, that is 343 GFLOP against
// 134 MB in bf16, so it is bound by operations.  This design does 16 hd
// flops a pair (the scores three times, dO V^T twice) on the CUDA cores,
// with every operand read from shared memory by scalar loads (a 4 x 4
// score tile per thread: one load per two FMAs), so it sits far from the
// bf16 tensor-core bound, and against the fp32 FMA peak.
//
// Tiles: 64 queries; 64 keys up to hd 128 and 32 keys above (the four
// operand tiles of (b) fit 227 KB of shared memory at hd 256).  Rows of
// shared tiles are HDP + 1 floats long (HDP: hd rounded up to 64, 96, 128
// or 256), so that 16 lanes reading one column of 16 rows hit 16 banks;
// columns past hd and rows past T are zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // queries per tile
constexpr float kNeg = -1e30f;     // the forward's masked score

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Dims {
  int B, Tq, Tk, H, KV, hd, causal, window;
  float scale;
};

__device__ __forceinline__ bool live(int t, int j, const Dims& d) {
  if (t >= d.Tq || j >= d.Tk) return false;
  if (d.causal && j > t) return false;
  if (d.window > 0 && t - j >= d.window) return false;
  return true;
}

// [lo, hi): the key tiles of BK keys that positions [q_lo, q_lo + kBQ)
// can see (the forward's relevance test, flash_attention.py:key_tiles)
template <int BK>
__device__ __forceinline__ void key_tiles(int q_lo, const Dims& d, int& lo,
                                          int& hi) {
  hi = (d.Tk + BK - 1) / BK;
  if (d.causal) hi = min(hi, (q_lo + kBQ - 1) / BK + 1);
  lo = d.window > 0 ? max(0, (q_lo - d.window + 1) / BK) : 0;
}

// rows [r0, r0 + R) of head h of batch b of a (B, n, heads, hd) tensor,
// times mul, into s[R][HDP + 1]; zero past n and past hd
template <typename T, int R, int HDP>
__device__ __forceinline__ void load_tile(float* s, const T* g, int b,
                                          int r0, int n, int heads, int h,
                                          int hd, float mul) {
  for (int i = threadIdx.x; i < R * HDP; i += kThreads) {
    const int r = i / HDP, c = i - (i / HDP) * HDP;
    float x = 0.f;
    if (r0 + r < n && c < hd)
      x = to_f(g[(((int64_t)b * n + r0 + r) * heads + h) * hd + c]) * mul;
    s[r * (HDP + 1) + c] = x;
  }
}

// acc[i][j] = sum_c A[ty * 4 + i][c] * Bt[tx + 16 j][c] over c < hd: the
// (64, 16 KJ) tile of A Bt^T, a 4 x KJ piece per thread
template <int KJ, int HDP>
__device__ __forceinline__ void dot_tile(float (&acc)[4][KJ], const float* A,
                                         const float* Bt, int ty, int tx,
                                         int hd) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
  const float* a0 = A + (ty * 4) * (HDP + 1);
  const float* b0 = Bt + tx * (HDP + 1);
#pragma unroll 4
  for (int c = 0; c < hd; ++c) {
    float a[4], bb[KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * (HDP + 1) + c];
#pragma unroll
    for (int j = 0; j < KJ; ++j) bb[j] = b0[j * 16 * (HDP + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// over the 16 lanes of a score row (tx = lane & 15)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (a) lse and D of one (b, h, query tile)
template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(kThreads)
    bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ lse, float* __restrict__ Dv, Dims d) {
  constexpr int KJ = BK / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                       // kBQ x (HDP + 1), scaled
  float* Ks = Qs + kBQ * (HDP + 1);       // BK x (HDP + 1)
  const int bh = blockIdx.x, b = bh / d.H, h = bh - b * d.H;
  const int kvh = h / (d.H / d.KV);
  const int nqt = (d.Tq + kBQ - 1) / kBQ;
  const int q_lo = (nqt - 1 - (int)blockIdx.y) * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;

  // D: a warp per row, lanes over hd
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int t = q_lo + r;
    if (t >= d.Tq) continue;
    const int64_t base = (((int64_t)b * d.Tq + t) * d.H + h) * d.hd;
    float acc = 0.f;
    for (int c = lane; c < d.hd; c += 32)
      acc = fmaf(to_f(dout[base + c]), to_f(o[base + c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) Dv[(int64_t)bh * d.Tq + t] = acc;
  }

  load_tile<T, kBQ, HDP>(Qs, q, b, q_lo, d.Tq, d.H, h, d.hd, d.scale);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNeg, l[i] = 0.f;
  int lo, hi;
  key_tiles<BK>(q_lo, d, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();
    load_tile<T, BK, HDP>(Ks, k, b, kt * BK, d.Tk, d.KV, kvh, d.hd, 1.f);
    __syncthreads();
    float s[4][KJ];
    dot_tile<KJ, HDP>(s, Qs, Ks, ty, tx, d.hd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q_lo + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        if (live(t, kt * BK + tx + 16 * j, d)) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        if (live(t, kt * BK + tx + 16 * j, d)) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(sum);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q_lo + ty * 4 + i;
      // a row with no live key gets p = 0 everywhere below
      if (t < d.Tq)
        lse[(int64_t)bh * d.Tq + t] = l[i] > 0.f ? m[i] + logf(l[i])
                                                 : __int_as_float(0x7f800000);
    }
  }
}

// (b) dK and dV of one (b, KV head, key tile)
template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ Dv, T* __restrict__ dk,
                    T* __restrict__ dv, Dims d) {
  constexpr int KJ = BK / 16;
  constexpr int CX = 1024 / BK;         // column lanes of the accumulators
  constexpr int CW = HDP / CX;          // columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                          // BK x (HDP + 1)
  float* Vs = Ks + BK * (HDP + 1);           // BK x (HDP + 1)
  float* Qs = Vs + BK * (HDP + 1);           // kBQ x (HDP + 1), scaled
  float* dOs = Qs + kBQ * (HDP + 1);         // kBQ x (HDP + 1)
  float* Ps = dOs + kBQ * (HDP + 1);         // kBQ x (BK + 1)
  float* dSs = Ps + kBQ * (BK + 1);          // kBQ x (BK + 1)
  float* Ls = dSs + kBQ * (BK + 1);          // kBQ
  float* Ds = Ls + kBQ;                      // kBQ
  const int bk = blockIdx.x, b = bk / d.KV, kvh = bk - b * d.KV;
  const int G = d.H / d.KV;
  const int k_lo = blockIdx.y * BK;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ky = tid / CX, cx = tid - (tid / CX) * CX;

  load_tile<T, BK, HDP>(Ks, k, b, k_lo, d.Tk, d.KV, kvh, d.hd, 1.f);
  load_tile<T, BK, HDP>(Vs, v, b, k_lo, d.Tk, d.KV, kvh, d.hd, 1.f);
  float accV[4][CW], accK[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) accV[i][j] = accK[i][j] = 0.f;

  // the query rows that can see keys [k_lo, k_lo + BK)
  const int t_lo = d.causal ? k_lo : 0;
  const int t_hi = d.window > 0 ? min(d.Tq, k_lo + BK - 1 + d.window) : d.Tq;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t row0 = ((int64_t)b * d.H + h) * d.Tq;
    for (int q_lo = t_lo / kBQ * kBQ; q_lo < t_hi; q_lo += kBQ) {
      __syncthreads();
      load_tile<T, kBQ, HDP>(Qs, q, b, q_lo, d.Tq, d.H, h, d.hd, d.scale);
      load_tile<T, kBQ, HDP>(dOs, dout, b, q_lo, d.Tq, d.H, h, d.hd, 1.f);
      if (tid < kBQ) {
        const int t = q_lo + tid;
        Ls[tid] = t < d.Tq ? lse[row0 + t] : 0.f;
        Ds[tid] = t < d.Tq ? Dv[row0 + t] : 0.f;
      }
      __syncthreads();
      float s[4][KJ], dp[4][KJ];
      dot_tile<KJ, HDP>(s, Qs, Ks, ty, tx, d.hd);
      dot_tile<KJ, HDP>(dp, dOs, Vs, ty, tx, d.hd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int c = tx + 16 * j;
          const float p = live(q_lo + r, k_lo + c, d) ? expf(s[i][j] - Ls[r])
                                                      : 0.f;
          Ps[r * (BK + 1) + c] = p;
          dSs[r * (BK + 1) + c] = p * (dp[i][j] - Ds[r]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pv[4], sv[4], ov[CW], qv[CW];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * (BK + 1) + ky * 4 + i];
          sv[i] = dSs[r * (BK + 1) + ky * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          ov[j] = dOs[r * (HDP + 1) + cx + CX * j];
          qv[j] = Qs[r * (HDP + 1) + cx + CX * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            accV[i][j] = fmaf(pv[i], ov[j], accV[i][j]);
            accK[i][j] = fmaf(sv[i], qv[j], accK[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j_ = k_lo + ky * 4 + i;
    if (j_ >= d.Tk) continue;
    const int64_t base = (((int64_t)b * d.Tk + j_) * d.KV + kvh) * d.hd;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int c = cx + CX * j;
      if (c < d.hd) {
        dv[base + c] = from_f<T>(accV[i][j]);
        dk[base + c] = from_f<T>(accK[i][j]);
      }
    }
  }
}

// (c) dQ of one (b, h, query tile)
template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ Dv,
                  T* __restrict__ dq, Dims d) {
  constexpr int KJ = BK / 16;
  constexpr int CW = HDP / 16;          // columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // kBQ x (HDP + 1), scaled
  float* dOs = Qs + kBQ * (HDP + 1);         // kBQ x (HDP + 1)
  float* Ks = dOs + kBQ * (HDP + 1);         // BK x (HDP + 1)
  float* Vs = Ks + BK * (HDP + 1);           // BK x (HDP + 1)
  float* dSs = Vs + BK * (HDP + 1);          // kBQ x (BK + 1)
  float* Ls = dSs + kBQ * (BK + 1);          // kBQ
  float* Ds = Ls + kBQ;                      // kBQ
  const int bh = blockIdx.x, b = bh / d.H, h = bh - b * d.H;
  const int kvh = h / (d.H / d.KV);
  const int nqt = (d.Tq + kBQ - 1) / kBQ;
  const int q_lo = (nqt - 1 - (int)blockIdx.y) * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t row0 = (int64_t)bh * d.Tq;

  load_tile<T, kBQ, HDP>(Qs, q, b, q_lo, d.Tq, d.H, h, d.hd, d.scale);
  load_tile<T, kBQ, HDP>(dOs, dout, b, q_lo, d.Tq, d.H, h, d.hd, 1.f);
  if (tid < kBQ) {
    const int t = q_lo + tid;
    Ls[tid] = t < d.Tq ? lse[row0 + t] : 0.f;
    Ds[tid] = t < d.Tq ? Dv[row0 + t] : 0.f;
  }
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
  int lo, hi;
  key_tiles<BK>(q_lo, d, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();
    load_tile<T, BK, HDP>(Ks, k, b, kt * BK, d.Tk, d.KV, kvh, d.hd, 1.f);
    load_tile<T, BK, HDP>(Vs, v, b, kt * BK, d.Tk, d.KV, kvh, d.hd, 1.f);
    __syncthreads();
    float s[4][KJ], dp[4][KJ];
    dot_tile<KJ, HDP>(s, Qs, Ks, ty, tx, d.hd);
    dot_tile<KJ, HDP>(dp, dOs, Vs, ty, tx, d.hd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = tx + 16 * j;
        const float p = live(q_lo + r, kt * BK + c, d) ? expf(s[i][j] - Ls[r])
                                                       : 0.f;
        dSs[r * (BK + 1) + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[4], kv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < CW; ++j) kv[j] = Ks[c * (HDP + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q_lo + ty * 4 + i;
    if (t >= d.Tq) continue;
    const int64_t base = (((int64_t)b * d.Tq + t) * d.H + h) * d.hd;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int c = tx + 16 * j;
      if (c < d.hd) dq[base + c] = from_f<T>(acc[i][j] * d.scale);
    }
  }
}

template <int HDP, int BK>
constexpr size_t rows_smem() {
  return sizeof(float) * (size_t)(kBQ + BK) * (HDP + 1);
}

template <int HDP, int BK>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * kBQ) * (HDP + 1) +
                          2 * kBQ * (BK + 1) + 2 * kBQ);
}

template <int HDP, int BK>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * kBQ) * (HDP + 1) +
                          kBQ * (BK + 1) + 2 * kBQ);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HDP, int BK>
int launch_rows(const void* q, const void* k, const void* o, const void* dout,
                void* lse, void* D, const Dims& d, cudaStream_t s) {
  constexpr size_t smem = rows_smem<HDP, BK>();
  int err = prepare(bwd_rows_kernel<T, HDP, BK>, smem);
  if (err) return err;
  const dim3 grid(d.B * d.H, (d.Tq + kBQ - 1) / kBQ);
  bwd_rows_kernel<T, HDP, BK><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)o, (const T*)dout, (float*)lse,
      (float*)D, d);
  return (int)cudaGetLastError();
}

template <typename T, int HDP, int BK>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* D, void* dk, void* dv,
                const Dims& d, cudaStream_t s) {
  constexpr size_t smem = dkdv_smem<HDP, BK>();
  int err = prepare(bwd_dkdv_kernel<T, HDP, BK>, smem);
  if (err) return err;
  const dim3 grid(d.B * d.KV, (d.Tk + BK - 1) / BK);
  bwd_dkdv_kernel<T, HDP, BK><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)D, (T*)dk, (T*)dv, d);
  return (int)cudaGetLastError();
}

template <typename T, int HDP, int BK>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* D, void* dq, const Dims& d,
              cudaStream_t s) {
  constexpr size_t smem = dq_smem<HDP, BK>();
  int err = prepare(bwd_dq_kernel<T, HDP, BK>, smem);
  if (err) return err;
  const dim3 grid(d.B * d.H, (d.Tq + kBQ - 1) / kBQ);
  bwd_dq_kernel<T, HDP, BK><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)D, (T*)dq, d);
  return (int)cudaGetLastError();
}

bool valid(const Dims& d) {
  return d.B > 0 && d.Tq > 0 && d.Tk > 0 && d.H > 0 && d.KV > 0 &&
         d.H % d.KV == 0 && d.hd > 0 && d.hd <= 256 && d.hd % 8 == 0 &&
         d.window >= 0 && (d.Tq + kBQ - 1) / kBQ <= 65535 &&
         (d.Tk + 31) / 32 <= 65535;
}

// F(T, HDP, BK) for the head-dim class of d.hd and the dtype flag
#define REPRO_BWD_DISPATCH(F, bf16, d, ...)                              \
  do {                                                                   \
    if (bf16) {                                                          \
      if ((d).hd <= 64) return F<__nv_bfloat16, 64, 64>(__VA_ARGS__);    \
      if ((d).hd <= 96) return F<__nv_bfloat16, 96, 64>(__VA_ARGS__);    \
      if ((d).hd <= 128) return F<__nv_bfloat16, 128, 64>(__VA_ARGS__);  \
      return F<__nv_bfloat16, 256, 32>(__VA_ARGS__);                     \
    }                                                                    \
    if ((d).hd <= 64) return F<float, 64, 64>(__VA_ARGS__);              \
    if ((d).hd <= 96) return F<float, 96, 64>(__VA_ARGS__);              \
    if ((d).hd <= 128) return F<float, 128, 64>(__VA_ARGS__);            \
    return F<float, 256, 32>(__VA_ARGS__);                               \
  } while (0)

}  // namespace

// q, o, dout (B, Tq, H, hd) and k, v (B, Tk, KV, hd), contiguous, fp32
// (bf16 = 0) or bf16 (bf16 = 1); lse and D (B, H, Tq) fp32 outputs.
extern "C" int repro_flash_attention_bwd_rows(
    const void* q, const void* k, const void* o, const void* dout, void* lse,
    void* D, int B, int Tq, int Tk, int H, int KV, int hd, int causal,
    int window, float scale, int bf16, void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  REPRO_BWD_DISPATCH(launch_rows, bf16, d, q, k, o, dout, lse, D, d,
                     (cudaStream_t)stream);
}

// dk, dv (B, Tk, KV, hd) outputs in the inputs' dtype; lse and D from
// repro_flash_attention_bwd_rows on the same stream.
extern "C" int repro_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dk, void* dv, int B, int Tq, int Tk,
    int H, int KV, int hd, int causal, int window, float scale, int bf16,
    void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  REPRO_BWD_DISPATCH(launch_dkdv, bf16, d, q, k, v, dout, lse, D, dk, dv, d,
                     (cudaStream_t)stream);
}

// dq (B, Tq, H, hd) output in the inputs' dtype.
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dq, int B, int Tq, int Tk, int H,
    int KV, int hd, int causal, int window, float scale, int bf16,
    void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  REPRO_BWD_DISPATCH(launch_dq, bf16, d, q, k, v, dout, lse, D, dq, d,
                     (cudaStream_t)stream);
}
