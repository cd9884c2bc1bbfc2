// The Hopper (sm_90a) building blocks of the bf16 flash-attention kernels,
// forward (flash_attention_wgmma.cu) and backward
// (flash_attention_bwd_wgmma.cu up to hd 128,
// flash_attention_bwd_wgmma_wide.cu above): shared-memory addresses,
// mbarriers, TMA loads, 128-byte-swizzled wgmma descriptors, the bf16 wgmma
// products with fp32 accumulators, the persistent item order, the
// backward's masks, D rows, gradient stores and key items, and the
// host-side 4-d tensor maps over (B, T, heads, hd).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- PTX helpers: shared addresses, mbarriers, TMA, wgmma -----------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor of a 128-byte-swizzled tile; lbo and sbo
// in bytes (K-major: sbo = 1024 between 8-row groups, lbo unused;
// MN-major: lbo between 64-column blocks, sbo = 1024 between 8-row groups)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// 2^x, flushing results below 2^-126 to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma operand lists name every accumulator register: the m64nN fp32
// fragment d (N / 2 floats a thread) is operands %0 .. %(N/2 - 1), the
// other operands follow it.  SS: A and B from K-major shared-memory
// descriptors, D = A B (acc = 0) or D += A B.  RS: A (bf16 pairs) from
// registers, B MN-major (the transpose bit), D += A B.  Each is one
// overload per fragment size.
#define WG_D8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32(i) WG_D8(i), WG_D8(i + 8), WG_D8(i + 16), WG_D8(i + 24)
#define WG_D64 WG_D32(0), WG_D32(32)
#define WG_D96 WG_D64, WG_D32(64)
#define WG_D128 WG_D96, WG_D32(96)
#define WG_S32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_S64 \
  WG_S32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_S96 \
  WG_S64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95"
#define WG_S128 \
  WG_S96 ", " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

// PRED: the operand that sets the scale-d predicate; AB: the A and B
// operands as the instruction lists them
#define WG_SS(N, S, D, PRED, AB)                                           \
  __device__ __forceinline__ void wgmma_ss(float(&d)[N / 2], uint64_t da, \
                                           uint64_t db, int acc) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"        \
                 "wgmma.mma_async.sync.aligned.m64n" #N                    \
                 "k16.f32.bf16.bf16 {" S "}, " AB ", p, 1, 1, 0, 0;\n}\n"  \
                 : D                                                       \
                 : "l"(da), "l"(db), "r"(acc));                            \
  }
#define WG_RS(N, S, D, PRED, AB)                                           \
  __device__ __forceinline__ void wgmma_rs(                                \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t db) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"        \
                 "wgmma.mma_async.sync.aligned.m64n" #N                    \
                 "k16.f32.bf16.bf16 {" S "}, " AB ", p, 1, 1, 1;\n}\n"     \
                 : D                                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                   "r"(1));                                                \
  }
WG_SS(64, WG_S32, WG_D32(0), "%34", "%32, %33")
WG_SS(128, WG_S64, WG_D64, "%66", "%64, %65")
WG_RS(64, WG_S32, WG_D32(0), "%37", "{%32, %33, %34, %35}, %36")
WG_RS(128, WG_S64, WG_D64, "%69", "{%64, %65, %66, %67}, %68")
WG_RS(192, WG_S96, WG_D96, "%101", "{%96, %97, %98, %99}, %100")
WG_RS(256, WG_S128, WG_D128, "%133", "{%128, %129, %130, %131}, %132")

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- the products of one tile ---------------------------------------------

// issue D = A B^T over HDP columns: A the warpgroup's 64 rows, B N rows,
// both K-major tiles of 128-byte column boxes (the A box 64 * 128 bytes,
// the B box N * 128 bytes), HDP / 16 products (+32 bytes per 16 columns).
// The forward's S = Q K^T; the backward's S^T = K Q^T, dP^T = V dO^T,
// S = Q K^T and dP = dO V^T.
template <int HDP, int N>
__device__ __forceinline__ void issue_qk(float (&sc)[N / 2], uint32_t a_base,
                                         uint32_t b_base) {
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks)
    wgmma_ss(sc,
             desc_sw128(a_base + (ks >> 2) * 64 * 128 + (ks & 3) * 32, 16,
                        1024),
             desc_sw128(b_base + (ks >> 2) * N * 128 + (ks & 3) * 32, 16,
                        1024),
             ks > 0);
}

// issue D += A B over K rows of B: A (64 x K, bf16) from registers, B an
// MN-major tile of K rows by HDP columns (16 rows = 2048 bytes a step,
// 128-byte column boxes K * 128 bytes apart), K / 16 products.  The
// forward's O += P V; the backward's dV += P^T dO, dK += dS^T Q and
// dQ += dS K.
template <int HDP, int K>
__device__ __forceinline__ void issue_pv(float (&acc)[HDP / 2],
                                         const uint32_t (&pa)[K / 16][4],
                                         uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs(acc, pa[kk], desc_sw128(b_base + kk * 16 * 128, K * 128, 1024));
}

// an fp32 accumulator fragment to bf16 pairs: the m64nN accumulator layout
// is the register layout of wgmma's A operand, 16 columns (4 registers)
// per product
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N / 2],
                                       uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// Persistent blocks walk their items heaviest first: block g of the grid
// takes item r * grid + g in even rounds r and r * grid + grid - 1 - g in
// odd ones, which evens out decreasing costs across the blocks.
__device__ __forceinline__ int item_index(int round) {
  return round * gridDim.x +
         ((round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// One query-tile work item: a (batch * head, BQ-query tile) pair and the
// key tiles [lo, hi) of BK keys it walks (the Pallas relevance test).
// Items are numbered heaviest causal tile first.
struct Item {
  int b, h, q_lo, lo, hi;
};

template <int BQ, int BK>
__device__ __forceinline__ Item query_item(int idx, int BH, int H, int nq,
                                           int Tk, int causal, int window) {
  Item it;
  const int bh = idx % BH;
  it.b = bh / H;
  it.h = bh - it.b * H;
  it.q_lo = (nq - 1 - idx / BH) * BQ;
  const int nk = (Tk + BK - 1) / BK;
  it.hi = causal ? min(nk, (it.q_lo + BQ + BK - 1) / BK) : nk;
  // a tile past Tk + window - 1 has no live key: lo = hi, no K/V tile
  it.lo = (window > 0 && it.q_lo - window + 1 > 0)
              ? min((it.q_lo - window + 1) / BK, it.hi) : 0;
  return it;
}

// ---- the backward's masks, D rows, stores and key items ----------------

struct Dims {
  int B, Tq, Tk, H, KV, hd, causal, window;
  float scale;
};

__device__ __forceinline__ bool live(int t, int j, const Dims& d) {
  bool ok = t < d.Tq && j < d.Tk;
  if (d.causal) ok = ok && j <= t;
  if (d.window > 0) ok = ok && t - j < d.window;
  return ok;
}

// whether rows [t0, t0 + nt) and keys [j0, j0 + nj) hold a live pair (any)
// or hold only live pairs (whole)
__device__ __forceinline__ bool any_live(int t0, int nt, int j0, int nj,
                                         const Dims& d) {
  return t0 < d.Tq && j0 < d.Tk && (!d.causal || j0 <= t0 + nt - 1) &&
         (d.window == 0 || t0 - (j0 + nj - 1) < d.window);
}

__device__ __forceinline__ bool all_live(int t0, int nt, int j0, int nj,
                                         const Dims& d) {
  return t0 + nt <= d.Tq && j0 + nj <= d.Tk &&
         (!d.causal || j0 + nj - 1 <= t0) &&
         (d.window == 0 || t0 + nt - 1 - j0 < d.window);
}

// sum of the products of 8 bf16 pairs, in fp32
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// the two rows (r, r + 8) of an accumulator fragment to bf16 gradients
// times mul, columns below hd, rows below n; `g` points at row r, column 0
template <int HDP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* g, int64_t stride,
                                           const float (&acc)[HDP / 2],
                                           float mul, int r, int n, int hd,
                                           int c0) {
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + c0;
    if (8 * j < hd) {
      if (r < n)
        *reinterpret_cast<__nv_bfloat162*>(g + col) =
            __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
      if (r + 8 < n)
        *reinterpret_cast<__nv_bfloat162*>(g + 8 * stride + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * mul,
                                  acc[4 * j + 3] * mul);
    }
  }
}

// D = rowsum(dO o) of this thread's rows r0 and r0 + 8 in fp32, the four
// threads of a row taking every fourth 8-column chunk; `g0` is row r0's
// offset in o and dout (row stride rs).  Written to Drow[r] for the rows
// below ldr, 0 on rows past Tq (the padding the dkdv launch reads).
__device__ __forceinline__ float2 row_D(const __nv_bfloat16* __restrict__ o,
                                        const __nv_bfloat16* __restrict__ dout,
                                        float* __restrict__ Drow, int64_t g0,
                                        int64_t rs, int r0, int ldr, int lane,
                                        const Dims& d) {
  float D0 = 0.f, D1 = 0.f;
  for (int c = 8 * (lane & 3); c < d.hd; c += 32) {
    if (r0 < d.Tq)
      D0 += dot8(*reinterpret_cast<const uint4*>(o + g0 + c),
                 *reinterpret_cast<const uint4*>(dout + g0 + c));
    if (r0 + 8 < d.Tq)
      D1 += dot8(*reinterpret_cast<const uint4*>(o + g0 + 8 * rs + c),
                 *reinterpret_cast<const uint4*>(dout + g0 + 8 * rs + c));
  }
  D0 += __shfl_xor_sync(0xffffffffu, D0, 1);
  D0 += __shfl_xor_sync(0xffffffffu, D0, 2);
  D1 += __shfl_xor_sync(0xffffffffu, D1, 1);
  D1 += __shfl_xor_sync(0xffffffffu, D1, 2);
  if ((lane & 3) == 0) {
    if (r0 < ldr) Drow[r0] = D0;
    if (r0 + 8 < ldr) Drow[r0 + 8] = D1;
  }
  return make_float2(D0, D1);
}

// One key-tile work item of a dkdv launch: a (b, KV head, KT-key tile)
// and the BQ-query tiles [qt_lo, qt_hi) that can see its keys (causal:
// t >= k_lo; window: t < k_lo + KT - 1 + window).  Items are numbered
// heaviest causal tile (the first keys) first.
struct KeyItem {
  int b, kvh, k_lo, qt_lo, qt_hi;
};

template <int KT, int BQ>
__device__ __forceinline__ KeyItem key_item(int idx, const Dims& d) {
  KeyItem it;
  const int BK = d.B * d.KV;
  const int bk = idx % BK;
  it.b = bk / d.KV;
  it.kvh = bk - it.b * d.KV;
  it.k_lo = idx / BK * KT;
  const int t_lo = d.causal ? it.k_lo : 0;
  const int t_hi =
      d.window > 0 ? min(d.Tq, it.k_lo + KT - 1 + d.window) : d.Tq;
  it.qt_lo = t_lo / BQ;
  it.qt_hi = t_lo < t_hi ? (t_hi + BQ - 1) / BQ : it.qt_lo;
  return it;
}

// ---- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no libcuda link)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, T, nh, hd) bf16 tensor as a 4-d map (hd innermost), boxes of
// 64 columns by `rows` rows of one head, 128-byte swizzle, zeros outside
bool make_map(CUtensorMap* map, const void* ptr, int B, int T, int nh, int hd,
              int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)nh, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)nh * hd * 2,
                                 (cuuint64_t)T * nh * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the row stride of the saved lse and D, (B, H, lse_rows(Tq)) fp32: Tq
// rounded up to 64, so that a 64-row tile of either is one 256-byte bulk
// copy; rows past Tq hold lse = +inf and D = 0
__host__ __device__ __forceinline__ int lse_rows(int Tq) {
  return (Tq + 63) / 64 * 64;
}

// q, dO (B, Tq, H, hd) as 4-d maps of 64-row boxes, k, v (B, Tk, KV, hd)
// of kv_rows-row boxes
bool make_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
               CUtensorMap* tdo, const void* q, const void* k, const void* v,
               const void* dout, const Dims& d, int kv_rows) {
  return make_map(tq, q, d.B, d.Tq, d.H, d.hd, 64) &&
         make_map(tk, k, d.B, d.Tk, d.KV, d.hd, kv_rows) &&
         make_map(tv, v, d.B, d.Tk, d.KV, d.hd, kv_rows) &&
         make_map(tdo, dout, d.B, d.Tq, d.H, d.hd, 64);
}

// the grid: one block per SM, at most one per item
template <typename K>
int prepare(K kernel, int smem, int64_t items, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  *grid = (int)(items < sms ? items : sms);
  return (int)err;
}

}  // namespace
