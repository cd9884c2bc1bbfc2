// The bf16 backward of the port's flash attention on Hopper (sm_90a): dQ, dK
// and dV of causal, sliding-window or bidirectional GQA attention at head
// dims up to 128, every product on the bf16 tensor cores (wgmma) with fp32
// accumulators, the tiles brought into shared memory by the TMA.  fp32
// inputs and head dims above 128 stay on csrc/flash_attention_bwd.cu.
//
// Replaces no TPU kernel: the Pallas kernel it differentiates
// (src/repro/kernels/flash_attention.py:flash_attention_pallas) is
// forward-only, and the JAX package trains by XLA's autodiff of the jnp
// _flash (src/repro/models/attention.py).  It is the backward of
// csrc/flash_attention_wgmma.cu, bound through ops.FlashAttentionFn.
//
//   s[t, j] = scale * q[b, t, h] . k[b, j, h / G]   (live pairs only)
//   p[t, j] = exp(s[t, j] - lse[t])      (lse saved by the bf16 forward)
//   D[t] = sum_c dO[t, c] O[t, c]
//   dV[j] = sum_{h in group, t} p[t, j] dO[t]
//   dS[t, j] = p[t, j] (dO[t] . v[j] - D[t])
//   dQ[t] = scale * sum_j dS[t, j] k[j]
//   dK[j] = scale * sum_{h in group, t} dS[t, j] q[t]
// over the keys j < Tk with (causal: j <= t) and (window > 0: t - j <
// window), the forward's masks, positions being the absolute indices.  A
// row with no live key has lse = +inf (the forward's max still NEG) and
// zero gradients.  The products round P and dS to bf16 as their A
// operands (2^-9 relative each), as the forward rounds P; every sum is
// fp32, and the gradients are rounded to bf16 once.
//
// Two launches on one stream, deterministic, no atomics (a step is
// bitwise repeatable on one card):
//   (a) dq: one work item is a (b, h, 128-query tile), 64 rows to each of
//       two consumer warpgroups, Q and dO resident.  It computes each
//       row's D = rowsum(dO o) itself and writes it to fp32 scratch for
//       (b), then walks the 64-key tiles the forward's relevance test
//       keeps: S = Q K^T and dP = dO V^T (both operands K-major in shared
//       memory), P = 2^(S scale log2 e - lse log2 e) and dS = P (dP - D)
//       in the accumulator fragment, then dQ += dS K with dS from
//       registers and K read through the transpose bit of an MN-major
//       descriptor.
//   (b) dkdv: one work item is a (b, KV head, 128-key tile), 64 keys to
//       each consumer warpgroup, K and V resident.  It walks the G query
//       heads of the group and the 64-query tiles that can see its keys:
//       S^T = K Q^T and dP^T = V dO^T, P^T and dS^T formed in the
//       fragment with each column's lse and D, then dV += P^T dO and
//       dK += dS^T Q with P^T and dS^T from registers and dO and Q read
//       MN-major.  dK and dV stay in fp32 registers until the item ends.
//
// What bounds it on the card: 10 hd flops per unmasked (q, k) pair and
// head (QK^T, dO V^T, P^T dO, dS^T Q and dS K) against q, k, v, o and dO
// read once and dQ, dK and dV written once: at granite-3-8b's training
// shape (1, 4096, 32, 8, 128), causal, 343 GFLOP against 134 MB, bound by
// operations (0.348 ms at the 989 TFLOP/s bf16 peak).  The two-launch
// form recomputes S and dP in (b): 14 hd flops a pair, so it can reach at
// most 71% (10 / 14) of that bound.  The design keeps the tensor cores
// fed the way the forward does: one producer thread streams the tiles
// with cp.async.bulk.tensor over 4-d CUtensorMaps of the real (B, T,
// heads, hd) strides (KV head h / G, no copy; rows past T and columns
// past hd arrive as the TMA's zeros, so hd 80 pads to 128 in shared
// memory only), and the rows' lse and D as 256-byte bulk copies, into a
// two-stage ring guarded by mbarriers; setmaxnreg gives the consumers 240
// registers (dK and dV of 64 keys at hd 128 are 128 of them); the two
// consumer warpgroups run unsynchronised, so one's exponentials and
// masks overlap the other's products; persistent blocks, one per SM, walk
// the items heaviest causal tile first in snake order.  Per warpgroup a
// tile's products are issued S first, then dP, and P is formed while dP
// still runs.  The PTX helpers and the products are flash_wgmma.cuh's.
//
// Shared memory at HDP 128 (hd 72..128): (a) 128 KB of Q, dO and two K/V
// stages; (b) 128 KB of K, V and two Q/dO stages, + 1 KB of lse and D.

#include "flash_wgmma.cuh"

namespace {

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRows = 64;                       // rows of one warpgroup
constexpr int kTile = kRows * kConsumers;       // (a) queries, (b) keys
constexpr int kBK = 64;                         // (a) keys per K/V tile
constexpr int kBQ = 64;                         // (b) queries per Q/dO tile
constexpr int kStages = 2;                      // ring depth
constexpr uint32_t kBox = 64 * 128;             // 64 rows x 64 bf16 columns

// ---- (a) dq ------------------------------------------------------------------

// byte offsets from the 1024-aligned base of dynamic shared memory
template <int HDP>
struct DqLayout {
  static constexpr int kChunks = HDP / 64;             // 128-byte boxes
  static constexpr uint32_t kWG = kChunks * kBox;      // 64 rows of Q or dO
  static constexpr uint32_t kKV = kChunks * kBK * 128;  // one K or V stage
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kConsumers * kWG;
  static constexpr uint32_t kK = 2 * kConsumers * kWG;
  static constexpr uint32_t kV = kK + kStages * kKV;
  static constexpr uint32_t kBar = kV + kStages * kKV;
  // barriers: Q/dO full, Q/dO empty, then per stage K/V full, K/V empty;
  // + slack to align the base
  static constexpr uint32_t kTotal = kBar + 8 * (2 + 2 * kStages) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ Dv,
                          __nv_bfloat16* __restrict__ dq, Dims d) {
  using L = DqLayout<HDP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_qe = bar_q + 8;
  const uint32_t bar_f = bar_qe + 8;                  // + 8 s for stage s
  const uint32_t bar_e = bar_f + 8 * kStages;

  const int BH = d.B * d.H;
  const int nq = (d.Tq + kTile - 1) / kTile;
  const int n_items = BH * nq;
  const int G = d.H / d.KV;
  const int ldr = lse_rows(d.Tq);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 128 * kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every load ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      int i = 0;   // K/V tiles loaded so far, over all items
      for (int r = 0, idx; (idx = item_index(r)) < n_items; ++r) {
        const Item it = query_item<kTile, kBK>(idx, BH, d.H, nq, d.Tk,
                                               d.causal, d.window);
        const int kvh = it.h / G;
        mbar_wait(bar_qe, (r & 1) ^ 1);
        mbar_expect_tx(bar_q, 2 * kConsumers * L::kWG);
        for (int g = 0; g < kConsumers; ++g)
          for (int c = 0; c < L::kChunks; ++c) {
            const uint32_t off = g * L::kWG + c * kBox;
            const int t0 = it.q_lo + kRows * g;
            tma_load_4d(base + L::kQ + off, &tq, bar_q, 64 * c, it.h, t0,
                        it.b);
            tma_load_4d(base + L::kDO + off, &tdo, bar_q, 64 * c, it.h, t0,
                        it.b);
          }
        for (int kt = it.lo; kt < it.hi; ++kt, ++i) {
          const int s = i % kStages;
          const uint32_t phase = (i / kStages) & 1;
          mbar_wait(bar_e + 8 * s, phase ^ 1);
          mbar_expect_tx(bar_f + 8 * s, 2 * L::kKV);
          for (int c = 0; c < L::kChunks; ++c) {
            const uint32_t off = s * L::kKV + c * kBK * 128;
            tma_load_4d(base + L::kK + off, &tk, bar_f + 8 * s, 64 * c, kvh,
                        kt * kBK, it.b);
            tma_load_4d(base + L::kV + off, &tv, bar_f + 8 * s, 64 * c, kvh,
                        kt * kBK, it.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int row = kRows * wg + 16 * (t >> 5) + (lane >> 2);  // in the tile
    const int c0 = 2 * (lane & 3);                             // column pair
    const uint32_t q_base = base + L::kQ + wg * L::kWG;
    const uint32_t do_base = base + L::kDO + wg * L::kWG;
    const float scale_log2 = d.scale * kLog2e;
    const float inf = __int_as_float(0x7f800000);
    const int64_t rs = (int64_t)d.H * d.hd;    // a row of q, o, dO, dq

    int i0 = 0;   // K/V tiles consumed before this item
    for (int r = 0, idx; (idx = item_index(r)) < n_items; ++r) {
      const Item it = query_item<kTile, kBK>(idx, BH, d.H, nq, d.Tk,
                                             d.causal, d.window);
      const int qa = it.q_lo + kRows * wg;    // the warpgroup's first row
      const int r0 = it.q_lo + row;           // this thread's rows r0, r0 + 8
      const int64_t bh = (int64_t)it.b * d.H + it.h;
      // the rows' lse in log2 units (+inf past lse_rows: no such row)
      const float m0 = r0 < ldr ? lse[bh * ldr + r0] * kLog2e : inf;
      const float m1 = r0 + 8 < ldr ? lse[bh * ldr + r0 + 8] * kLog2e : inf;
      // D = rowsum(dO o), 0 on rows past Tq (the padding (b) reads)
      const int64_t g0 = ((int64_t)it.b * d.Tq + r0) * rs + it.h * d.hd;
      const float2 Dr = row_D(o, dout, Dv + bh * ldr, g0, rs, r0, ldr, lane,
                              d);
      const float D0 = Dr.x, D1 = Dr.y;

      float acc[HDP / 2];
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
      mbar_wait(bar_q, r & 1);
      const int n = it.hi - it.lo;
      for (int j = 0; j < n; ++j) {
        const int s = (i0 + j) % kStages;
        const int k_lo = (it.lo + j) * kBK;
        mbar_wait(bar_f + 8 * s, ((i0 + j) / kStages) & 1);
        if (any_live(qa, kRows, k_lo, kBK, d)) {
          const uint32_t k_s = base + L::kK + s * L::kKV;
          const uint32_t v_s = base + L::kV + s * L::kKV;
          float sc[kBK / 2], dp[kBK / 2];
          uint32_t da[kBK / 16][4];
          wgmma_fence();
          issue_qk<HDP, kBK>(sc, q_base, k_s);
          wgmma_commit();
          issue_qk<HDP, kBK>(dp, do_base, v_s);
          wgmma_commit();
          wgmma_wait<1>();              // S is done, dP may run on
          fence_regs(sc);
          const bool whole = all_live(qa, kRows, k_lo, kBK, d);
#pragma unroll
          for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = ex2(fmaf(sc[4 * jj + e], scale_log2,
                                 -((e >> 1) ? m1 : m0)));
              if (!whole &&
                  !live(r0 + 8 * (e >> 1), k_lo + 8 * jj + c0 + (e & 1), d))
                p = 0.f;
              sc[4 * jj + e] = p;
            }
          wgmma_wait<0>();
          fence_regs(dp);
          if (j == n - 1) mbar_arrive(bar_qe);   // the item's Q and dO
#pragma unroll
          for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * jj + e] =
                  sc[4 * jj + e] * (dp[4 * jj + e] - ((e >> 1) ? D1 : D0));
          pack_p<kBK>(dp, da);
          wgmma_fence();
          issue_pv<HDP, kBK>(acc, da, k_s);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(da);
        } else if (j == n - 1) {
          mbar_arrive(bar_qe);
        }
        mbar_arrive(bar_e + 8 * s);
      }
      if (n == 0) mbar_arrive(bar_qe);
      i0 += n;
      store_rows<HDP>(dq + g0, rs, acc, d.scale, r0, d.Tq, d.hd, c0);
    }
  }
}

// ---- (b) dkdv ----------------------------------------------------------------

template <int HDP>
struct DkdvLayout {
  static constexpr int kChunks = HDP / 64;
  static constexpr uint32_t kWG = kChunks * kBox;       // 64 keys of K or V
  static constexpr uint32_t kQT = kChunks * kBQ * 128;  // one Q or dO tile
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kConsumers * kWG;
  static constexpr uint32_t kQ = 2 * kConsumers * kWG;  // + 2 s kQT, dO + kQT
  static constexpr uint32_t kRowsOff = kQ + kStages * 2 * kQT;  // lse, D
  static constexpr uint32_t kRowsBytes = kBQ * 4;               // each
  static constexpr uint32_t kBar = kRowsOff + kStages * 2 * kRowsBytes;
  // barriers: K/V full, K/V empty, then per stage Q/dO full, Q/dO empty
  static constexpr uint32_t kTotal = kBar + 8 * (2 + 2 * kStages) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ Dv,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Dims d) {
  using L = DkdvLayout<HDP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_kve = bar_kv + 8;
  const uint32_t bar_f = bar_kve + 8;                 // + 8 s for stage s
  const uint32_t bar_e = bar_f + 8 * kStages;

  const int nkt = (d.Tk + kTile - 1) / kTile;
  const int n_items = d.B * d.KV * nkt;
  const int G = d.H / d.KV;
  const int ldr = lse_rows(d.Tq);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kve, 128 * kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every load ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      int i = 0;   // Q/dO tiles loaded so far, over all items
      for (int r = 0, idx; (idx = item_index(r)) < n_items; ++r) {
        const KeyItem it = key_item<kTile, kBQ>(idx, d);
        mbar_wait(bar_kve, (r & 1) ^ 1);
        mbar_expect_tx(bar_kv, 2 * kConsumers * L::kWG);
        for (int g = 0; g < kConsumers; ++g)
          for (int c = 0; c < L::kChunks; ++c) {
            const uint32_t off = g * L::kWG + c * kBox;
            const int j0 = it.k_lo + kRows * g;
            tma_load_4d(base + L::kK + off, &tk, bar_kv, 64 * c, it.kvh, j0,
                        it.b);
            tma_load_4d(base + L::kV + off, &tv, bar_kv, 64 * c, it.kvh, j0,
                        it.b);
          }
        for (int hg = 0; hg < G; ++hg) {
          const int h = it.kvh * G + hg;
          const int64_t row0 = ((int64_t)it.b * d.H + h) * ldr;
          for (int qt = it.qt_lo; qt < it.qt_hi; ++qt, ++i) {
            const int s = i % kStages;
            const uint32_t phase = (i / kStages) & 1;
            const uint32_t q_s = base + L::kQ + s * 2 * L::kQT;
            const uint32_t rows_s = base + L::kRowsOff + s * 2 * L::kRowsBytes;
            mbar_wait(bar_e + 8 * s, phase ^ 1);
            mbar_expect_tx(bar_f + 8 * s, 2 * L::kQT + 2 * L::kRowsBytes);
            for (int c = 0; c < L::kChunks; ++c) {
              tma_load_4d(q_s + c * kBQ * 128, &tq, bar_f + 8 * s, 64 * c, h,
                          qt * kBQ, it.b);
              tma_load_4d(q_s + L::kQT + c * kBQ * 128, &tdo, bar_f + 8 * s,
                          64 * c, h, qt * kBQ, it.b);
            }
            bulk_load(rows_s, lse + row0 + qt * kBQ, L::kRowsBytes,
                      bar_f + 8 * s);
            bulk_load(rows_s + L::kRowsBytes, Dv + row0 + qt * kBQ,
                      L::kRowsBytes, bar_f + 8 * s);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int kr = 16 * (t >> 5) + (lane >> 2);   // key row in the WG's 64
    const int c0 = 2 * (lane & 3);                // query column pair
    const uint32_t k_base = base + L::kK + wg * L::kWG;
    const uint32_t v_base = base + L::kV + wg * L::kWG;
    const float scale_log2 = d.scale * kLog2e;
    const int64_t rs = (int64_t)d.KV * d.hd;    // a row of k, v, dk, dv

    int i0 = 0;   // Q/dO tiles consumed before this item
    for (int r = 0, idx; (idx = item_index(r)) < n_items; ++r) {
      const KeyItem it = key_item<kTile, kBQ>(idx, d);
      const int kw = it.k_lo + kRows * wg;    // the warpgroup's first key
      const int key0 = kw + kr;               // this thread's keys, and + 8
      float dka[HDP / 2], dva[HDP / 2];
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) dka[j] = dva[j] = 0.f;
      mbar_wait(bar_kv, r & 1);
      const int nq = it.qt_hi - it.qt_lo;
      const int n = G * nq;
      for (int j = 0; j < n; ++j) {
        const int s = (i0 + j) % kStages;
        const int q_lo = (it.qt_lo + j % nq) * kBQ;   // head j / nq
        mbar_wait(bar_f + 8 * s, ((i0 + j) / kStages) & 1);
        if (any_live(q_lo, kBQ, kw, kRows, d)) {
          const uint32_t q_s = base + L::kQ + s * 2 * L::kQT;
          const uint32_t do_s = q_s + L::kQT;
          const float* lse_s = reinterpret_cast<const float*>(
              sbase + L::kRowsOff + s * 2 * L::kRowsBytes);
          const float* D_s = lse_s + kBQ;
          float sc[kBQ / 2], dp[kBQ / 2];
          uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
          wgmma_fence();
          issue_qk<HDP, kBQ>(sc, k_base, q_s);      // S^T = K Q^T
          wgmma_commit();
          issue_qk<HDP, kBQ>(dp, v_base, do_s);     // dP^T = V dO^T
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sc);
          const bool whole = all_live(q_lo, kBQ, kw, kRows, d);
#pragma unroll
          for (int jj = 0; jj < kBQ / 8; ++jj) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(lse_s + 8 * jj + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = ex2(fmaf(sc[4 * jj + e], scale_log2,
                                 -((e & 1) ? l2.y : l2.x) * kLog2e));
              if (!whole &&
                  !live(q_lo + 8 * jj + c0 + (e & 1), key0 + 8 * (e >> 1), d))
                p = 0.f;
              sc[4 * jj + e] = p;
            }
          }
          wgmma_wait<0>();
          fence_regs(dp);
#pragma unroll
          for (int jj = 0; jj < kBQ / 8; ++jj) {
            const float2 D2 =
                *reinterpret_cast<const float2*>(D_s + 8 * jj + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * jj + e] =
                  sc[4 * jj + e] * (dp[4 * jj + e] - ((e & 1) ? D2.y : D2.x));
          }
          pack_p<kBQ>(sc, pa);
          pack_p<kBQ>(dp, da);
          wgmma_fence();
          issue_pv<HDP, kBQ>(dva, pa, do_s);        // dV += P^T dO
          issue_pv<HDP, kBQ>(dka, da, q_s);         // dK += dS^T Q
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
          fence_regs(pa);
          fence_regs(da);
        }
        mbar_arrive(bar_e + 8 * s);
      }
      i0 += n;
      mbar_arrive(bar_kve);                         // the item's K and V
      const int64_t g0 = ((int64_t)it.b * d.Tk + key0) * rs +
                         (int64_t)it.kvh * d.hd;
      store_rows<HDP>(dk + g0, rs, dka, d.scale, key0, d.Tk, d.hd, c0);
      store_rows<HDP>(dv + g0, rs, dva, 1.f, key0, d.Tk, d.hd, c0);
    }
  }
}

// ---- host side ----------------------------------------------------------------

template <int HDP>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* D, void* dq,
              const Dims& d, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_maps(&tq, &tk, &tv, &tdo, q, k, v, dout, d, kBK))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)DqLayout<HDP>::kTotal;
  int grid = 0;
  const int err = prepare(flash_bwd_wgmma_dq_kernel<HDP>, smem,
                          (int64_t)d.B * d.H * ((d.Tq + kTile - 1) / kTile),
                          &grid);
  if (err) return err;
  flash_bwd_wgmma_dq_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
      (const float*)lse, (float*)D, (__nv_bfloat16*)dq, d);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* D, void* dk,
                void* dv, const Dims& d, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_maps(&tq, &tk, &tv, &tdo, q, k, v, dout, d, kRows))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)DkdvLayout<HDP>::kTotal;
  int grid = 0;
  const int err = prepare(flash_bwd_wgmma_dkdv_kernel<HDP>, smem,
                          (int64_t)d.B * d.KV * ((d.Tk + kTile - 1) / kTile),
                          &grid);
  if (err) return err;
  flash_bwd_wgmma_dkdv_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)D,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, d);
  return (int)cudaGetLastError();
}

bool valid(const Dims& d) {
  return d.B > 0 && d.Tq > 0 && d.Tk > 0 && d.H > 0 && d.KV > 0 &&
         d.H % d.KV == 0 && d.hd > 0 && d.hd <= 128 && d.hd % 8 == 0 &&
         d.window >= 0;
}

}  // namespace

// q, o, dout (B, Tq, H, hd) and k, v (B, Tk, KV, hd), bf16, contiguous
// and 16-byte aligned, hd a multiple of 8 up to 128; lse (B, H,
// lse_rows(Tq)) fp32 from the bf16 forward; D (B, H, lse_rows(Tq)) fp32
// scratch that this launch writes for the dkdv launch; dq (B, Tq, H, hd)
// bf16 output.
extern "C" int repro_flash_attention_bwd_wgmma_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, int B, int Tq,
    int Tk, int H, int KV, int hd, int causal, int window, float scale,
    void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return hd <= 64 ? launch_dq<64>(q, k, v, o, dout, lse, D, dq, d, s)
                  : launch_dq<128>(q, k, v, o, dout, lse, D, dq, d, s);
}

// dk, dv (B, Tk, KV, hd) bf16 outputs; lse and D as the dq launch took and
// wrote them, on the same stream after it.
extern "C" int repro_flash_attention_bwd_wgmma_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dk, void* dv, int B, int Tq,
    int Tk, int H, int KV, int hd, int causal, int window, float scale,
    void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return hd <= 64 ? launch_dkdv<64>(q, k, v, dout, lse, D, dk, dv, d, s)
                  : launch_dkdv<128>(q, k, v, dout, lse, D, dk, dv, d, s);
}
