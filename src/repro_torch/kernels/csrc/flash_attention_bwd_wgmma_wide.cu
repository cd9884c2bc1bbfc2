// The bf16 backward of the port's flash attention on Hopper (sm_90a) at head
// dims above 128 (136..256, padded to HDP 192 or 256 in shared memory
// only): dQ, dK and dV of causal, sliding-window or bidirectional GQA
// attention, every product on the bf16 tensor cores (wgmma) with fp32
// accumulators, the tiles brought into shared memory by the TMA.  Head dims
// up to 128 run csrc/flash_attention_bwd_wgmma.cu, fp32 inputs
// csrc/flash_attention_bwd.cu.
//
// Replaces no TPU kernel: the Pallas kernel it differentiates
// (src/repro/kernels/flash_attention.py:flash_attention_pallas) is
// forward-only, and the JAX package trains by XLA's autodiff of the jnp
// _flash (src/repro/models/attention.py).  It is the backward of
// csrc/flash_attention_wgmma.cu at HDP 192 and 256, bound through
// ops.FlashAttentionFn.
//
// It computes what flash_attention_bwd_wgmma.cu computes:
//   s[t, j] = scale * q[b, t, h] . k[b, j, h / G]   (live pairs only)
//   p[t, j] = exp(s[t, j] - lse[t])      (lse saved by the bf16 forward)
//   D[t] = sum_c dO[t, c] O[t, c]
//   dV[j] = sum_{h in group, t} p[t, j] dO[t]
//   dS[t, j] = p[t, j] (dO[t] . v[j] - D[t])
//   dQ[t] = scale * sum_j dS[t, j] k[j]
//   dK[j] = scale * sum_{h in group, t} dS[t, j] q[t]
// over the forward's live pairs (causal, window, Tq != Tk, positions the
// absolute indices).  A row with no live key has lse = +inf and zero
// gradients.  P and dS are rounded to bf16 as wgmma A operands (2^-9
// relative each); P enters dS in fp32; every sum is fp32, and the
// gradients are rounded to bf16 once.
//
// Why it is not flash_attention_bwd_wgmma.cu at a wider HDP: there a
// warpgroup holds dK and dV of its 64 keys, 2 x 64 x HDP / 128 fp32
// registers a thread: 256 at HDP 256, over the 255-register limit before
// S and dP are counted; and its dq launch holds Q and dO of 128 queries
// (128 KB at HDP 256) beside two 64-key K/V stages (128 KB), over the
// 227 KB a block may have.  The two launches here:
//   (a) dq: one work item is a (b, h, 128-query tile), 64 rows to each of
//       two consumer warpgroups, Q and dO resident (128 KB at HDP 256).
//       K streams through a two-stage ring and V through one stage (96
//       KB): V is released as soon as dP = dO V^T is done, K only after
//       dQ += dS K, so the next V loads under the dS and dQ work.  Each
//       warpgroup computes its rows' D = rowsum(dO o) (written to fp32
//       scratch for (b)), then per 64-key tile S = Q K^T and dP = dO V^T
//       (both operands K-major), P = 2^(S scale log2 e - lse log2 e) and
//       dS = P (dP - D) in the fragment, and dQ += dS K with dS from
//       registers and K read MN-major.  dQ is 128 fp32 registers at HDP
//       256, S and dP 32 each.
//   (b) dkdv: one work item is a (b, KV head, 64-key tile), K and V
//       resident, the G query heads' 64-query Q/dO tiles streaming
//       through a two-stage ring with their lse and D rows.  The two
//       consumer warpgroups split the gradients, not the keys: warpgroup
//       0 forms S^T = K Q^T and P^T (the mask and lse) and accumulates
//       dV += P^T dO; warpgroup 1 forms dP^T = V dO^T, takes P^T in fp32
//       from warpgroup 0 through shared memory (two 16 KB slots in the
//       fragment order, each thread reading what the same thread of
//       warpgroup 0 wrote; mbarriers full and empty per slot), forms
//       dS^T = P^T (dP^T - D) and accumulates dK += dS^T Q.  Each holds
//       one HDP-wide accumulator (128 registers at HDP 256) and does 4 hd
//       flops a pair, and one exchange a tile suffices, where splitting
//       the columns of dK and dV between them needs P^T and dS^T both
//       ways and a barrier between.
//
// What bounds it on the card: 10 hd flops per live (q, k) pair and head
// against q, k, v, o and dO read once and dQ, dK and dV written once.  At
// gemma3-4b's local layer, (1, 4096, 8, 4, 256) with window 1024, that is
// 75.2 GFLOP against 84 MB: bound by operations, 0.076 ms at the 989
// TFLOP/s bf16 peak; its global layer (causal over 4096) 171.8 GFLOP, 0.174
// ms.  The two-launch form recomputes S and dP in (b), 14 hd flops a pair:
// at most 71% of that bound.  Kept from flash_attention_bwd_wgmma.cu: one
// producer thread streams the tiles with cp.async.bulk.tensor over 4-d
// CUtensorMaps of the real (B, T, heads, hd) strides (KV head h / G, no
// copy; rows past T and columns past hd arrive as the TMA's zeros), the
// rows' lse and D as 256-byte bulk copies (rows padded to 64);
// setmaxnreg gives the consumers 240 registers; persistent blocks, one
// per SM, walk the items heaviest causal tile first in snake order.  The
// PTX helpers, the products, the masks and the stores are
// flash_wgmma.cuh's.
//
// Shared memory at HDP 256: (a) 224 KB of Q, dO, two K stages and one V
// stage; (b) 64 KB of K and V, 128 KB of two Q/dO stages, 1 KB of lse and
// D, 32 KB of P^T slots: 225 KB.  HDP 192 takes three quarters of each
// tile.

#include "flash_wgmma.cuh"

namespace {

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRows = 64;                       // (a) rows of one warpgroup
constexpr int kQTile = kRows * kConsumers;      // (a) queries per item
constexpr int kBK = 64;                         // keys per tile and (b) item
constexpr int kBQ = 64;                         // (b) queries per Q/dO tile
constexpr int kKStages = 2;                     // (a) K ring depth
constexpr int kStages = 2;                      // (b) Q/dO ring, P^T slots
constexpr uint32_t kBox = 64 * 128;             // 64 rows x 64 bf16 columns

// ---- (a) dq ------------------------------------------------------------------

// byte offsets from the 1024-aligned base of dynamic shared memory
template <int HDP>
struct DqLayout {
  static constexpr int kChunks = HDP / 64;             // 128-byte boxes
  static constexpr uint32_t kWG = kChunks * kBox;      // 64 rows of Q or dO
  static constexpr uint32_t kKV = kChunks * kBK * 128;  // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kConsumers * kWG;
  static constexpr uint32_t kK = 2 * kConsumers * kWG;
  static constexpr uint32_t kV = kK + kKStages * kKV;
  static constexpr uint32_t kBar = kV + kKV;
  // barriers: Q/dO full and empty, V full and empty, then per stage K full,
  // then per stage K empty; + slack to align the base
  static constexpr uint32_t kTotal = kBar + 8 * (4 + 2 * kKStages) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_dq_kernel(const __grid_constant__ CUtensorMap tq,
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
  const uint32_t bar_v = bar_qe + 8;
  const uint32_t bar_ve = bar_v + 8;
  const uint32_t bar_k = bar_ve + 8;                  // + 8 s for stage s
  const uint32_t bar_ke = bar_k + 8 * kKStages;

  const int BH = d.B * d.H;
  const int nq = (d.Tq + kQTile - 1) / kQTile;
  const int n_items = BH * nq;
  const int G = d.H / d.KV;
  const int ldr = lse_rows(d.Tq);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 128 * kConsumers);
    mbar_init(bar_v, 1);
    mbar_init(bar_ve, 128 * kConsumers);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_ke + 8 * s, 128 * kConsumers);
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
        const Item it = query_item<kQTile, kBK>(idx, BH, d.H, nq, d.Tk,
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
          const int s = i % kKStages;
          mbar_wait(bar_ke + 8 * s, ((i / kKStages) & 1) ^ 1);
          mbar_expect_tx(bar_k + 8 * s, L::kKV);
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_4d(base + L::kK + s * L::kKV + c * kBK * 128, &tk,
                        bar_k + 8 * s, 64 * c, kvh, kt * kBK, it.b);
          mbar_wait(bar_ve, (i & 1) ^ 1);
          mbar_expect_tx(bar_v, L::kKV);
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_4d(base + L::kV + c * kBK * 128, &tv, bar_v, 64 * c,
                        kvh, kt * kBK, it.b);
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
    const uint32_t v_s = base + L::kV;
    const float scale_log2 = d.scale * kLog2e;
    const float inf = __int_as_float(0x7f800000);
    const int64_t rs = (int64_t)d.H * d.hd;    // a row of q, o, dO, dq

    int i0 = 0;   // K/V tiles consumed before this item
    for (int r = 0, idx; (idx = item_index(r)) < n_items; ++r) {
      const Item it = query_item<kQTile, kBK>(idx, BH, d.H, nq, d.Tk,
                                              d.causal, d.window);
      const int qa = it.q_lo + kRows * wg;    // the warpgroup's first row
      const int r0 = it.q_lo + row;           // this thread's rows r0, r0 + 8
      const int64_t bh = (int64_t)it.b * d.H + it.h;
      // the rows' lse in log2 units (+inf past lse_rows: no such row)
      const float m0 = r0 < ldr ? lse[bh * ldr + r0] * kLog2e : inf;
      const float m1 = r0 + 8 < ldr ? lse[bh * ldr + r0 + 8] * kLog2e : inf;
      const int64_t g0 = ((int64_t)it.b * d.Tq + r0) * rs + it.h * d.hd;
      const float2 Dr = row_D(o, dout, Dv + bh * ldr, g0, rs, r0, ldr, lane,
                              d);

      float acc[HDP / 2];
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
      mbar_wait(bar_q, r & 1);
      const int n = it.hi - it.lo;
      for (int j = 0; j < n; ++j) {
        const int i = i0 + j;
        const int s = i % kKStages;
        const int k_lo = (it.lo + j) * kBK;
        const uint32_t k_s = base + L::kK + s * L::kKV;
        mbar_wait(bar_k + 8 * s, (i / kKStages) & 1);
        mbar_wait(bar_v, i & 1);
        if (any_live(qa, kRows, k_lo, kBK, d)) {
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
          mbar_arrive(bar_ve);                   // V is read
          if (j == n - 1) mbar_arrive(bar_qe);   // the item's Q and dO
#pragma unroll
          for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * jj + e] =
                  sc[4 * jj + e] * (dp[4 * jj + e] - ((e >> 1) ? Dr.y : Dr.x));
          pack_p<kBK>(dp, da);
          wgmma_fence();
          issue_pv<HDP, kBK>(acc, da, k_s);      // dQ += dS K
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(da);
        } else {
          mbar_arrive(bar_ve);
          if (j == n - 1) mbar_arrive(bar_qe);
        }
        mbar_arrive(bar_ke + 8 * s);
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
  static constexpr uint32_t kKV = kChunks * kBox;       // 64 keys of K or V
  static constexpr uint32_t kQT = kChunks * kBQ * 128;  // one Q or dO tile
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kKV;
  static constexpr uint32_t kQ = 2 * kKV;               // + 2 s kQT, dO + kQT
  static constexpr uint32_t kRowsOff = kQ + kStages * 2 * kQT;  // lse, D
  static constexpr uint32_t kRowsBytes = kBQ * 4;               // each
  static constexpr uint32_t kP = kRowsOff + kStages * 2 * kRowsBytes;
  static constexpr uint32_t kPBytes = kBK * kBQ * 4;    // one fp32 P^T slot
  static constexpr uint32_t kBar = kP + kStages * kPBytes;
  // barriers: K/V full and empty, then per stage Q/dO full, Q/dO empty, per
  // slot P^T full, P^T empty
  static constexpr uint32_t kTotal = kBar + 8 * (2 + 4 * kStages) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
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
  uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_kve = bar_kv + 8;
  const uint32_t bar_f = bar_kve + 8;                 // + 8 s for stage s
  const uint32_t bar_e = bar_f + 8 * kStages;
  const uint32_t bar_pf = bar_e + 8 * kStages;        // + 8 s for slot s
  const uint32_t bar_pe = bar_pf + 8 * kStages;

  const int nkt = (d.Tk + kBK - 1) / kBK;
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
      mbar_init(bar_pf + 8 * s, 128);
      mbar_init(bar_pe + 8 * s, 128);
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
        const KeyItem it = key_item<kBK, kBQ>(idx, d);
        mbar_wait(bar_kve, (r & 1) ^ 1);
        mbar_expect_tx(bar_kv, 2 * L::kKV);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(base + L::kK + c * kBox, &tk, bar_kv, 64 * c, it.kvh,
                      it.k_lo, it.b);
          tma_load_4d(base + L::kV + c * kBox, &tv, bar_kv, 64 * c, it.kvh,
                      it.k_lo, it.b);
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
    // ---- consumers: warpgroup 0 P^T and dV, warpgroup 1 dS^T and dK -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int kr = 16 * (t >> 5) + (lane >> 2);   // key row in the 64
    const int c0 = 2 * (lane & 3);                // query column pair
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    const uint32_t a_base = base + (wg == 0 ? L::kK : L::kV);
    const float scale_log2 = d.scale * kLog2e;
    const int64_t rs = (int64_t)d.KV * d.hd;    // a row of k, v, dk, dv

    int i0 = 0;   // Q/dO tiles consumed before this item
    int np = 0;   // P^T tiles exchanged so far, over all items
    for (int r = 0, idx; (idx = item_index(r)) < n_items; ++r) {
      const KeyItem it = key_item<kBK, kBQ>(idx, d);
      const int key0 = it.k_lo + kr;          // this thread's keys, and + 8
      float acc[HDP / 2];                     // dV (wg 0) or dK (wg 1)
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
      mbar_wait(bar_kv, r & 1);
      const int nq = it.qt_hi - it.qt_lo;
      const int n = G * nq;
      for (int j = 0; j < n; ++j) {
        const int s = (i0 + j) % kStages;
        const int q_lo = (it.qt_lo + j % nq) * kBQ;   // head j / nq
        mbar_wait(bar_f + 8 * s, ((i0 + j) / kStages) & 1);
        if (any_live(q_lo, kBQ, it.k_lo, kBK, d)) {
          const uint32_t q_s = base + L::kQ + s * 2 * L::kQT;
          const uint32_t do_s = q_s + L::kQT;
          const float* lse_s = reinterpret_cast<const float*>(
              sbase + L::kRowsOff + s * 2 * L::kRowsBytes);
          const float* D_s = lse_s + kBQ;
          const int ps = np % kStages;
          const uint32_t pphase = (np / kStages) & 1;
          // this thread's part of the slot: float4 jj at slot[128 jj]
          float4* slot =
              reinterpret_cast<float4*>(sbase + L::kP + ps * L::kPBytes) + t;
          float sc[kBQ / 2];
          uint32_t pa[kBQ / 16][4];
          wgmma_fence();
          issue_qk<HDP, kBQ>(sc, a_base, wg == 0 ? q_s : do_s);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          if (wg == 0) {
            // P^T from each query column's lse, masked where the tile
            // crosses an edge; handed to warpgroup 1 in fp32
            const bool whole = all_live(q_lo, kBQ, it.k_lo, kBK, d);
#pragma unroll
            for (int jj = 0; jj < kBQ / 8; ++jj) {
              const float2 l2 =
                  *reinterpret_cast<const float2*>(lse_s + 8 * jj + c0);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float p = ex2(fmaf(sc[4 * jj + e], scale_log2,
                                   -((e & 1) ? l2.y : l2.x) * kLog2e));
                if (!whole && !live(q_lo + 8 * jj + c0 + (e & 1),
                                    key0 + 8 * (e >> 1), d))
                  p = 0.f;
                sc[4 * jj + e] = p;
              }
            }
            mbar_wait(bar_pe + 8 * ps, pphase ^ 1);
#pragma unroll
            for (int jj = 0; jj < kBQ / 8; ++jj)
              slot[128 * jj] = make_float4(sc[4 * jj], sc[4 * jj + 1],
                                           sc[4 * jj + 2], sc[4 * jj + 3]);
            mbar_arrive(bar_pf + 8 * ps);
          } else {
            // dS^T = P^T (dP^T - D), P^T as warpgroup 0 formed it
            mbar_wait(bar_pf + 8 * ps, pphase);
#pragma unroll
            for (int jj = 0; jj < kBQ / 8; ++jj) {
              const float4 p = slot[128 * jj];
              const float2 D2 =
                  *reinterpret_cast<const float2*>(D_s + 8 * jj + c0);
              sc[4 * jj] = p.x * (sc[4 * jj] - D2.x);
              sc[4 * jj + 1] = p.y * (sc[4 * jj + 1] - D2.y);
              sc[4 * jj + 2] = p.z * (sc[4 * jj + 2] - D2.x);
              sc[4 * jj + 3] = p.w * (sc[4 * jj + 3] - D2.y);
            }
            mbar_arrive(bar_pe + 8 * ps);
          }
          pack_p<kBQ>(sc, pa);
          wgmma_fence();
          // dV += P^T dO (wg 0) or dK += dS^T Q (wg 1), B read MN-major
          issue_pv<HDP, kBQ>(acc, pa, wg == 0 ? do_s : q_s);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(pa);
          ++np;
        }
        mbar_arrive(bar_e + 8 * s);
      }
      i0 += n;
      mbar_arrive(bar_kve);                         // the item's K and V
      const int64_t g0 = ((int64_t)it.b * d.Tk + key0) * rs +
                         (int64_t)it.kvh * d.hd;
      if (wg == 0)
        store_rows<HDP>(dv + g0, rs, acc, 1.f, key0, d.Tk, d.hd, c0);
      else
        store_rows<HDP>(dk + g0, rs, acc, d.scale, key0, d.Tk, d.hd, c0);
    }
  }
}

static_assert(DqLayout<256>::kTotal <= 232448, "dq shared memory");
static_assert(DkdvLayout<256>::kTotal <= 232448, "dkdv shared memory");

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
  const int err = prepare(flash_bwd_wide_dq_kernel<HDP>, smem,
                          (int64_t)d.B * d.H * ((d.Tq + kQTile - 1) / kQTile),
                          &grid);
  if (err) return err;
  flash_bwd_wide_dq_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
      (const float*)lse, (float*)D, (__nv_bfloat16*)dq, d);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* D, void* dk,
                void* dv, const Dims& d, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_maps(&tq, &tk, &tv, &tdo, q, k, v, dout, d, kBK))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)DkdvLayout<HDP>::kTotal;
  int grid = 0;
  const int err = prepare(flash_bwd_wide_dkdv_kernel<HDP>, smem,
                          (int64_t)d.B * d.KV * ((d.Tk + kBK - 1) / kBK),
                          &grid);
  if (err) return err;
  flash_bwd_wide_dkdv_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)D,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, d);
  return (int)cudaGetLastError();
}

bool valid(const Dims& d) {
  return d.B > 0 && d.Tq > 0 && d.Tk > 0 && d.H > 0 && d.KV > 0 &&
         d.H % d.KV == 0 && d.hd > 128 && d.hd <= 256 && d.hd % 8 == 0 &&
         d.window >= 0;
}

}  // namespace

// q, o, dout (B, Tq, H, hd) and k, v (B, Tk, KV, hd), bf16, contiguous
// and 16-byte aligned, hd a multiple of 8 from 136 to 256; lse (B, H,
// lse_rows(Tq)) fp32 from the bf16 forward; D (B, H, lse_rows(Tq)) fp32
// scratch that this launch writes for the dkdv launch; dq (B, Tq, H, hd)
// bf16 output.
extern "C" int repro_flash_attention_bwd_wide_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, int B, int Tq,
    int Tk, int H, int KV, int hd, int causal, int window, float scale,
    void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return hd <= 192 ? launch_dq<192>(q, k, v, o, dout, lse, D, dq, d, s)
                   : launch_dq<256>(q, k, v, o, dout, lse, D, dq, d, s);
}

// dk, dv (B, Tk, KV, hd) bf16 outputs; lse and D as the dq launch took and
// wrote them, on the same stream after it.
extern "C" int repro_flash_attention_bwd_wide_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dk, void* dv, int B, int Tq,
    int Tk, int H, int KV, int hd, int causal, int window, float scale,
    void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return hd <= 192 ? launch_dkdv<192>(q, k, v, dout, lse, D, dk, dv, d, s)
                   : launch_dkdv<256>(q, k, v, dout, lse, D, dk, dv, d, s);
}
