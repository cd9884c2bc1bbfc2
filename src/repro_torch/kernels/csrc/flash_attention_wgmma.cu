// Flash attention in bf16 for Hopper (sm_90a): causal or sliding-window GQA
// prefill attention with an online softmax, QK^T and PV on the bf16 tensor
// cores (wgmma), K and V brought into shared memory by the TMA.
//
// Replaces: src/repro/kernels/flash_attention.py:87 flash_attention_pallas,
// the Pallas TPU kernel that walks (bq, bk) score tiles with the running max,
// denominator and accumulator in VMEM scratch across the sequential kv grid
// axis, skipping tiles outside the causal / window bounds, with the K/V
// BlockSpec indexing head // G so GQA never copies K or V.  The fp32 route
// stays on the CUDA-core kernel of csrc/flash_attention.cu.
//
//   o[b, t, h] = sum_s softmax_s(scale * q[b, t, h] . k[b, s, h // G]) v[b, s, h // G]
//   over the keys s < Tk with (causal: s <= t) and (window > 0: t - s < window)
//
// Semantics kept from the Pallas kernel: the scores are fp32 sums of the
// bf16 products, times scale (called with scale = 1 on a q the caller has
// already scaled in bf16, it is the model's _flash product); the softmax
// is taken in log2 units (scores times scale * log2 e, 2^x for e^x); masked
// scores are the finite NEG = -1e30, never -inf, so 2^(NEG - NEG) = 1 where
// a row has seen no live key yet and the first live key's correction
// 2^(NEG - m) = 0 wipes that sum exactly (the difference is taken before the
// power, so NEG - NEG is exactly 0); the tile-skip bounds are the Pallas
// relevance test (k_lo <= q_hi, k_hi > q_lo - window); the running max,
// denominator and accumulator are fp32; the output is acc / max(l, 1e-30),
// rounded once to bf16.  The one new rounding is P: the probabilities enter
// the PV product as bf16 (the denominator sums them in fp32); the card
// tests hold the output within one bf16 ulp of the plain version with it.
//
// What bounds it on the card: 4 hd flops per unmasked (q, k) pair (QK^T and
// PV).  At the granite-3-8b prefill shape (1, 4096, 32 heads, 8 KV heads,
// hd 128, causal) that is 137.5 GFLOP against 42 MB of q, k, v and o: at the
// H100's 989 TFLOP/s bf16 tensor-core peak 0.139 ms, far above its 295 flop
// per byte, so it is bound by operations.  The design keeps the tensor cores
// fed: wgmma reads Q and K straight from shared memory, P stays in
// registers as the A operand of the PV product, a producer warp keeps the
// next K/V tiles in flight, each warpgroup runs one tile's softmax on the
// CUDA cores while the previous tile's PV product runs on the tensor cores,
// and the two consumer warpgroups take turns to issue their products (two
// named barriers), so one's softmax overlaps the other's products.
//
// Design: a persistent kernel, one block of three warpgroups per SM, each
// block walking its share of the (batch * head, 128-query tile) items, the
// heaviest causal tiles first and in snake order across the blocks (the
// next item's Q and K/V loads overlap the current item's last products and
// stores).  Warpgroups 0 and 1 consume, 64 query rows each; one thread of
// warpgroup 2 produces (setmaxnreg moves the registers to the consumers).  The producer loads an item's Q tile
// once (when the consumers have computed the previous item's last S) and
// then each BK-key tile of K and of V with cp.async.bulk.tensor over the
// real (B, T, heads, hd) strides of a 4-d CUtensorMap (KV head h // G, no
// copy), 64 columns (128 bytes) per box with the 128-byte swizzle, into a
// ring of two stages guarded by mbarriers (full: the TMA's bytes landed;
// empty: all 256 consumer threads are done, K as soon as S is computed, V
// once PV is).  Rows past T and columns past hd arrive as the TMA's
// out-of-bounds zeros, so a ragged T or an hd that is a multiple of 8 needs
// no padded copy; hd is padded to HDP (a multiple of 64) inside shared
// memory only.  A consumer computes S = Q K^T with wgmma.m64nBKk16 (both
// operands K-major shared-memory descriptors) and, in the same batch, the
// previous tile's O += P V with wgmma.m64nHDPk16 (P from registers, V read
// through the transpose bit of an MN-major descriptor); it waits for S
// only, scales and masks S in its accumulator fragment (masks only on
// tiles that cross the diagonal, the window edge or Tk), takes the row max
// with two shuffles among the four threads that share a row, and
// exponentiates, then waits for PV, rescales O by 2^(m - m_new) in fp32 and
// packs P to bf16 in the accumulator layout, which is the register A layout
// of the next PV product.  HDP <= 128 takes BK = 128 (160 KB of shared
// memory at hd 128); HDP 192 and 256 take BK = 64 (192 KB at hd 256).  The
// cuTensorMapEncodeTiled entry point comes from cudaGetDriverEntryPoint, so
// the library links no libcuda.  The PTX helpers, the products and the
// item order are in flash_wgmma.cuh, shared with the backward.
//
// For training the epilogue also writes each row's lse = (m + log2 l) ln 2
// (natural units, +inf for a row that saw no live key) into a (B, H,
// lse_rows(Tq)) fp32 array that the backward (flash_attention_bwd_wgmma.cu)
// reads instead of recomputing it; inference passes a null lse, and o is the
// same bit for bit either way.

#include "flash_wgmma.cuh"

namespace {

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kBQ = 64 * kConsumers;            // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                      // K/V ring depth

// named barriers 1 and 2 take turns between the two consumer warpgroups
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(128 * kConsumers)
               : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(128 * kConsumers)
               : "memory");
}


// The online softmax of one score tile, in place: the scores in log2 units
// (times scale * log2 e), masked to NEG where the tile crosses an edge
// (`whole` false), the row max over the four threads of a row, then
// p = 2^(s - m_new) with the difference taken first, so NEG - NEG is
// exactly 0 (p = 1).  Updates m and this thread's part of l; returns the
// factors 2^(m - m_new) that O must be scaled by.
struct Rows {
  float m0, m1, l0, l1;   // rows r0 and r0 + 8
};

template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], Rows& st,
                                               float& corr0, float& corr1,
                                               float scale_log2, bool whole,
                                               int k_lo, int r0, int c0,
                                               int Tk, int causal,
                                               int window) {
  float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale_log2;
      if (!whole) {
        const int key = k_lo + 8 * j + c0 + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        bool live = key < Tk;
        if (causal) live = live && key <= row;
        if (window > 0) live = live && row - key < window;
        if (!live) x = kNeg;
      }
      sc[4 * j + e] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m0, mx0);
  const float mn1 = fmaxf(st.m1, mx1);
  corr0 = ex2(st.m0 - mn0);
  corr1 = ex2(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = ex2(sc[4 * j] - mn0);
    sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn0);
    sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn1);
    sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn1);
    ps0 += sc[4 * j] + sc[4 * j + 1];
    ps1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = st.l0 * corr0 + ps0;
  st.l1 = st.l1 * corr1 + ps1;
}

template <int HDP>
__device__ __forceinline__ void rescale(float (&acc)[HDP / 2], float corr0,
                                        float corr1) {
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    acc[4 * j] *= corr0;
    acc[4 * j + 1] *= corr0;
    acc[4 * j + 2] *= corr1;
    acc[4 * j + 3] *= corr1;
  }
}

// ---- the kernel -------------------------------------------------------------

// byte offsets from the 1024-aligned base of dynamic shared memory
template <int HDP, int BK>
struct Layout {
  static constexpr int kChunks = HDP / 64;           // 128-byte column boxes
  static constexpr uint32_t kQTile = 64 * 128;       // one WG's rows, one box
  static constexpr uint32_t kQBytes = kBQ * HDP * 2;
  static constexpr uint32_t kKVBytes = BK * HDP * 2;  // one K or V stage
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kStages * kKVBytes;
  // barriers: Q full, Q empty, then per stage K full, V full, K empty,
  // V empty; + slack to align the base
  static constexpr uint32_t kTotal = kBar + 8 * (2 + 4 * kStages) + 1024;
};

// Persistent: one block per SM walks its items; the ring's stage and phase
// counters and the Q buffer's phase run on across items, so the producer
// loads the next item's Q and first K/V tiles while the consumers finish
// the current one.
template <int HDP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int B, int H, int KV, int Tq, int Tk, int hd, int causal,
                   int window, float scale) {
  using L = Layout<HDP, BK>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_qe = bar_q + 8;
  const uint32_t bar_k = bar_qe + 8;                  // + 8 s for stage s
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_ek = bar_v + 8 * kStages;
  const uint32_t bar_ev = bar_ek + 8 * kStages;

  const int BH = B * H;
  const int nq = (Tq + kBQ - 1) / kBQ;
  const int n_items = BH * nq;
  const int G = H / KV;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 128 * kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, 128 * kConsumers);
      mbar_init(bar_ev + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load --------------------
    // K of a stage is released once S is computed, V once PV is, so the
    // next K tile is in flight while the consumers are still on PV
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      int i = 0;   // K/V tiles loaded so far, over all items
      for (int r = 0, idx; (idx = item_index(r)) < n_items; ++r) {
        const Item it = query_item<kBQ, BK>(idx, BH, H, nq, Tk, causal, window);
        const int kvh = it.h / G;
        mbar_wait(bar_qe, (r & 1) ^ 1);
        mbar_expect_tx(bar_q, L::kQBytes);
        for (int g = 0; g < kConsumers; ++g)
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_4d(base + L::kQ + (g * L::kChunks + c) * L::kQTile, &tq,
                        bar_q, 64 * c, it.h, it.q_lo + 64 * g, it.b);
        for (int kt = it.lo; kt < it.hi; ++kt, ++i) {
          const int s = i % kStages;
          const uint32_t phase = (i / kStages) & 1;
          mbar_wait(bar_ek + 8 * s, phase ^ 1);
          mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_4d(base + L::kK + s * L::kKVBytes + c * BK * 128, &tk,
                        bar_k + 8 * s, 64 * c, kvh, kt * BK, it.b);
          mbar_wait(bar_ev + 8 * s, phase ^ 1);
          mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_4d(base + L::kV + s * L::kKVBytes + c * BK * 128, &tv,
                        bar_v + 8 * s, 64 * c, kvh, kt * BK, it.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ------------------------
    // Tile i's S = Q K^T is issued together with tile i-1's O += P V, and
    // tile i's softmax runs while that PV product is still in flight.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int row = 64 * wg + 16 * (t >> 5) + (lane >> 2);   // in the tile
    const int c0 = 2 * (lane & 3);                           // column pair
    const uint32_t q_base = base + L::kQ + wg * L::kChunks * L::kQTile;
    const float scale_log2 = scale * kLog2e;
    // the two warpgroups take turns to issue their products, so one's
    // softmax runs while the other's products hold the tensor cores;
    // warpgroup 0 goes first
    if (wg == 1) turn_pass(wg);

    int i0 = 0;   // K/V tiles consumed before this item
    for (int r = 0, idx; (idx = item_index(r)) < n_items; ++r) {
      const Item it = query_item<kBQ, BK>(idx, BH, H, nq, Tk, causal, window);
      const int qa = it.q_lo + 64 * wg;                 // the WG's first row
      const int r0 = it.q_lo + row;                     // rows r0, r0 + 8
      // whether the tile at k_lo needs no mask for any row of this WG
      auto whole = [&](int k_lo) {
        return k_lo + BK <= Tk && (!causal || k_lo + BK - 1 <= qa) &&
               (window == 0 || qa + 63 - k_lo < window);
      };

      float acc[HDP / 2];
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
      Rows st = {kNeg, kNeg, 0.f, 0.f};   // l: this thread's part
      float sc[BK / 2];
      uint32_t pa[BK / 16][4];
      float corr0, corr1;

      mbar_wait(bar_q, r & 1);
      const int n = it.hi - it.lo;
      if (n > 0) {
        // tile 0: S, softmax, P
        const int s = i0 % kStages;
        mbar_wait(bar_k + 8 * s, (i0 / kStages) & 1);
        turn_wait(wg);
        wgmma_fence();
        issue_qk<HDP, BK>(sc, q_base, base + L::kK + s * L::kKVBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(bar_ek + 8 * s);
        online_softmax<BK>(sc, st, corr0, corr1, scale_log2,
                           whole(it.lo * BK), it.lo * BK, r0, c0, Tk, causal,
                           window);
        pack_p<BK>(sc, pa);
      }
      for (int j = 1; j < n; ++j) {
        const int s = (i0 + j) % kStages;
        const int sp = (i0 + j - 1) % kStages;
        const int k_lo = (it.lo + j) * BK;
        mbar_wait(bar_k + 8 * s, ((i0 + j) / kStages) & 1);
        mbar_wait(bar_v + 8 * sp, ((i0 + j - 1) / kStages) & 1);
        turn_wait(wg);
        wgmma_fence();
        issue_qk<HDP, BK>(sc, q_base, base + L::kK + s * L::kKVBytes);
        wgmma_commit();
        issue_pv<HDP, BK>(acc, pa, base + L::kV + sp * L::kKVBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();              // S of tile j is done, PV may run on
        fence_regs(sc);
        mbar_arrive(bar_ek + 8 * s);
        online_softmax<BK>(sc, st, corr0, corr1, scale_log2, whole(k_lo),
                           k_lo, r0, c0, Tk, causal, window);
        wgmma_wait<0>();              // PV of tile j-1 is done
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(bar_ev + 8 * sp);
        rescale<HDP>(acc, corr0, corr1);
        pack_p<BK>(sc, pa);
      }
      mbar_arrive(bar_qe);            // every S of this item is done
      if (n > 0) {
        // the last tile's PV
        const int s = (i0 + n - 1) % kStages;
        mbar_wait(bar_v + 8 * s, ((i0 + n - 1) / kStages) & 1);
        turn_wait(wg);
        wgmma_fence();
        issue_pv<HDP, BK>(acc, pa, base + L::kV + s * L::kKVBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(bar_ev + 8 * s);
      }
      i0 += n;

      // the four threads of a row hold parts of its denominator
      float l0 = st.l0, l1 = st.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float den0 = fmaxf(l0, 1e-30f);
      const float den1 = fmaxf(l1, 1e-30f);
      if (lse != nullptr && (lane & 3) == 0) {
        // the row's natural-log lse for the backward, +inf where the row
        // saw no live key (its max still NEG) and on the padding rows
        const int ldr = lse_rows(Tq);
        float* lrow = lse + ((int64_t)it.b * H + it.h) * ldr;
        const float inf = __int_as_float(0x7f800000);
        if (r0 < ldr)
          lrow[r0] = r0 < Tq && st.m0 > kNeg ? (st.m0 + log2f(l0)) * kLn2
                                             : inf;
        if (r0 + 8 < ldr)
          lrow[r0 + 8] = r0 + 8 < Tq && st.m1 > kNeg
                             ? (st.m1 + log2f(l1)) * kLn2 : inf;
      }
      const int64_t row_stride = (int64_t)H * hd;
      __nv_bfloat16* o0 =
          o + ((int64_t)it.b * Tq + r0) * row_stride + (int64_t)it.h * hd;
      __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = 8 * j + c0;
        if (8 * j < hd) {
          if (r0 < Tq)
            *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
                __floats2bfloat162_rn(acc[4 * j] / den0,
                                      acc[4 * j + 1] / den0);
          if (r0 + 8 < Tq)
            *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
                __floats2bfloat162_rn(acc[4 * j + 2] / den1,
                                      acc[4 * j + 3] / den1);
        }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------

template <int HDP, int BK>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Tq, int Tk, int H, int KV, int hd, int causal,
           int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Tq, H, hd, 64) ||
      !make_map(&tk, k, B, Tk, KV, hd, BK) ||
      !make_map(&tv, v, B, Tk, KV, hd, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)Layout<HDP, BK>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HDP, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int64_t items = (int64_t)B * H * ((Tq + kBQ - 1) / kBQ);
  const int grid = (int)(items < sms ? items : sms);
  flash_wgmma_kernel<HDP, BK><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (float*)lse, B, H, KV, Tq, Tk, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, hd), k and v (B, Tk, KV, hd) and o (B, Tq, H, hd), bf16,
// contiguous and 16-byte aligned; hd a multiple of 8 up to 256; H a
// multiple of KV; B * H and the query tiles within the grid's limits
// (checked by the wrapper).  lse: null (inference), or (B, H,
// lse_rows(Tq)) fp32 for the backward, each row's natural-log
// logsumexp of its scaled scores over its live keys (+inf for none, and
// on the padding rows); o is the same bit for bit either way.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int Tq, int Tk, int H,
                                           int KV, int hd, int causal,
                                           int window, float scale,
                                           void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      hd <= 0 || hd > 256 || hd % 8 != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 63) / 64) {
    case 1:
      return launch<64, 128>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal,
                             window, scale, s);
    case 2:
      return launch<128, 128>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal,
                              window, scale, s);
    case 3:
      return launch<192, 64>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal,
                             window, scale, s);
    case 4:
      return launch<256, 64>(q, k, v, o, lse, B, Tq, Tk, H, KV, hd, causal,
                             window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
