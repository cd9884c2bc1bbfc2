// Flash attention in fp32 for Hopper: causal or sliding-window GQA prefill
// attention with an online softmax, on the CUDA cores.  The bf16 route is
// csrc/flash_attention_wgmma.cu (the tensor cores); this kernel takes fp32
// only, which the port keeps off the tensor cores (no TF32).
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
// pair (QK^T and PV); at the granite-3-8b prefill shape (T = 4096, 32 heads,
// hd = 128) that is 137 GFLOP against 42 MB of q, k, v and o, far above
// the H100's 295 flop per byte, so it is bound by operations.  In fp32 they
// are FMAs on the CUDA cores (67 TFLOP/s peak): 2.05 ms at that shape.
//
// Design: one block of 256 threads per (batch * head, 64-query tile); the
// heaviest causal tiles (the last ones) are scheduled first.  The q tile
// (scaled) stays in shared memory; each 64-key tile of K, then of V,
// is loaded into one shared buffer (K and V take turns, which
// keeps 2 blocks per SM at hd = 128).  Thread (ty, tx) of the 16 x 16 grid
// owns query rows ty + 16 i and key columns tx + 16 j (i, j < 4) of the
// score tile, read as float4 along hd from rows padded to hd + 4 floats so
// the 8 threads of a quarter-warp hit distinct banks; the row max and sum
// are shuffles within the 16 lanes of a row group.  P goes through shared
// memory, and the same thread accumulates rows ty + 16 i and the float4
// column groups tx + 16 g of the output in registers.  K and V are read
// through the (B, T, KV, hd) strides: no copy, no repeat over the group.
// Tiles outside [lo, hi) are skipped: hi by the causal bound
// (k_lo <= q_lo + 63), lo by the window bound (k_lo + 63 > q_lo - window),
// the same relevance test as the Pallas kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPStride = kBK + 4;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows [t0, t0 + 64) of one head of a (B, T, nh, hd) tensor into dst
// (row stride hd + 4) times mul; rows at or past T are zero
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row0, int t0, int T_,
                                          int nh, int hd, float mul) {
  const int groups = hd >> 2;
  for (int g = threadIdx.x; g < kBQ * groups; g += kThreads) {
    const int r = g / groups;
    const int c = (g - r * groups) << 2;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T_) {
      v = load4(src + (row0 + (int64_t)(t0 + r) * nh) * hd + c);
      v.x *= mul;
      v.y *= mul;
      v.z *= mul;
      v.w *= mul;
    }
    store4(dst + r * (hd + 4) + c, v);
  }
}

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

// NG: float4 column groups of the output per thread, ceil(hd / 64)
template <int NG>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H, int KV,
             int Tq, int Tk, int hd, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = hd + 4;
  float* q_s = smem;                    // (64, hd + 4)
  float* kv_s = q_s + kBQ * stride;     // (64, hd + 4): K, then V
  float* p_s = kv_s + kBK * stride;     // (64, 68)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heavy causal tiles first
  const int q_lo = qt * kBQ;
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
  if (causal) hi = min(nk, (q_lo + kBQ + kBK - 1) / kBK);
  int lo = 0;
  if (window > 0) lo = max(0, (q_lo - window + 1) / kBK);
  const int64_t kv_row0 = (int64_t)b * Tk * KV + kvh;

  for (int kt = lo; kt < hi; ++kt) {
    const int k_lo = kt * kBK;
    __syncthreads();   // the previous tile's PV is done with kv_s and p_s
    load_tile(kv_s, k, kv_row0, k_lo, Tk, KV, hd, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(q_s + (ty + 16 * i) * stride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = load4(kv_s + (tx + 16 * j) * stride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
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
        if (!live) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
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
      for (int i = 0; i < 4; ++i) pa[i] = load4(p_s + (ty + 16 * i) * kPStride + j);
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

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (hd + 4) + kBQ * kPStride);
}

template <int NG>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int KV, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  flash_kernel<NG><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H, KV, Tq,
      Tk, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, hd), k and v (B, Tk, KV, hd) and o (B, Tq, H, hd), fp32,
// contiguous and 16-byte aligned; hd a multiple of 8 up to 256; H a
// multiple of KV; B * H and the query tiles within the grid's limits
// (checked by the wrapper).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Tq,
                                     int Tk, int H, int KV, int hd, int causal,
                                     int window, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      hd <= 0 || hd > 256 || hd % 8 != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 63) / 64) {
    case 1:
      return launch<1>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                       scale, s);
    case 2:
      return launch<2>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                       scale, s);
    case 3:
      return launch<3>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                       scale, s);
    case 4:
      return launch<4>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                       scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
