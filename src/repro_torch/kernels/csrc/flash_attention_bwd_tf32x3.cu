// The fp32 backward of the port's flash attention on Hopper's tensor cores:
// dQ, dK and dV of causal, sliding-window or bidirectional GQA attention of
// fp32 inputs at every head dim up to 256, each product in split TF32
// (three mma.sync TF32 products per fp32 product, about 22 bits of it).
// bf16 inputs take csrc/flash_attention_bwd_wgmma.cu (hd <= 128) and
// csrc/flash_attention_bwd_wgmma_wide.cu (above); the CUDA-core backward,
// csrc/flash_attention_bwd.cu, stays only as a forced route for an A/B
// (kernels/flash_attention.py:bwd_route).
//
// Replaces no TPU kernel: the Pallas kernel it differentiates
// (src/repro/kernels/flash_attention.py:flash_attention_pallas) is
// forward-only, and the JAX package trains by XLA's autodiff of the jnp
// _flash (src/repro/models/attention.py).  It is the backward of the fp32
// forward, csrc/flash_attention.cu, bound through ops.FlashAttentionFn.
//
//   s[t, j] = q[b, t, h] . k[b, j, h / G]            (live pairs only)
//   p[t, j] = exp(scale s[t, j] - lse[t])   (lse saved by the fp32 forward)
//   D[t] = sum_c dO[t, c] O[t, c]
//   dV[j] = sum_{h in group, t} p[t, j] dO[t]
//   dS[t, j] = p[t, j] (dO[t] . v[j] - D[t])
//   dQ[t] = scale * sum_j dS[t, j] k[j]
//   dK[j] = scale * sum_{h in group, t} dS[t, j] q[t]
// over the forward's live pairs (causal, window, Tq != Tk, positions the
// absolute indices).  A row with no live key has lse = +inf and zero
// gradients.
//
// Split TF32: every product (S = Q K^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K) runs as mma.sync.m16n8k8 with TF32 inputs and
// fp32 accumulators.  Each fp32 operand x of a fragment is split in
// registers, hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is
// exact; |x - hi - lo| <= 2^-22 |x|); hi hi' goes to one fp32
// accumulator, lo hi' and hi lo' to another, added at the end; lo lo'
// (about 2^-22 relative) is dropped.  P and dS are split the same way.
// The tensor cores round their fp32 sums toward zero, so a long chain of
// products in one accumulator drifts (by 1.2e-5 of max |dK| over 24 tiles
// at (1, 333, 4, 1, 128) on an H100): dQ, dK and dV take each tile's
// product in fresh accumulators and add it to theirs in fp32 registers,
// rounded to nearest.  The gradients are held to the fp32 gate
// of the CUDA-core backward (1e-5 of each gradient's largest magnitude
// against the plain backward).  mma.sync and not
// wgmma: TF32 wgmma reads B only K-major from shared memory with both
// halves stored there, which at hd 128 would take twice the tiles and
// transposed copies of dO, Q and K beyond 227 KB; an mma.sync fragment is
// read from shared memory at any layout, so a transposed operand costs
// only its addresses.
//
// Two launches on one stream, deterministic, no atomics (a step is
// bitwise repeatable on one card), each a block of 8 warps per work item
// of R rows (R = 64 up to hd 128, 32 above, where the fp32 tiles of 64
// rows overflow shared memory), in two groups: group 0 forms the scores,
// group 1 dP, each warp 16 rows of them over all of hd (HS = 1) or, at
// R = 32, over half of hd (HS = 2: two warps a 16-row block, so the block
// still has 8 warps).  The warps write their parts in the accumulator's
// order to shared memory; after one barrier every warp sums the parts of
// its rows in a fixed order (so every warp holds the same S and dP) and
// forms what its product takes.
//   (a) dq: a (b, h, R-query tile), heaviest causal tiles first, Q and dO
//       resident.  It writes each row's D = rowsum(dO o) to fp32 scratch
//       for (b), then walks the R-key tiles the forward's relevance test
//       keeps (flash_attention.py:key_tiles), K and V streaming through a
//       two-stage 16-byte cp.async ring: S = Q K^T (group 0), dP = dO V^T
//       (group 1), then every warp P, dS = P (dP - D) and dQ += dS K over
//       its 2 HS-th of dQ's columns.
//   (b) dkdv: a (b, KV head, R-key tile), K and V resident, walking the G
//       heads of the group and the R-query tiles that can see its keys,
//       Q, dO and their lse and D rows streaming through the ring: S^T =
//       K Q^T (group 0), dP^T = V dO^T (group 1), then P^T, and group 0
//       dV += P^T dO, group 1 dS^T = P^T (dP^T - D) and dK += dS^T Q, each
//       over its HS-th of the columns.
// Both launches together do 14 hd flops a pair (S and dP twice).
//
// What bounds it on the card: 10 hd flops per live (q, k) pair and head
// against q, k, v, o and dO read once and dQ, dK and dV written once, three
// TF32 products each: at granite-3-8b's training shape (1, 4096, 32, 8,
// 128), causal, 3 x 343 GFLOP at 495 TFLOP/s, 2.08 ms, against 268 MB of
// fp32 (0.08 ms): bound by operations.  The design:
//   * Tiles whose rows are HDP floats (hd rounded up to 32) with the
//     16-byte chunks of row r XOR-swizzled by r & 7: a warp's row-wise
//     fragments (Q, K, V, dO as the K-major operands of S and dP: rows g,
//     columns tig) come by ldmatrix, 8 rows of 16 bytes a matrix, and its
//     transposed ones (K, Q, dO as the B operand of dS K, dS^T Q, P^T dO:
//     rows 2 tig and 2 tig + 1, columns g) by scalar LDS, both on 32
//     banks.
//   * The score accumulator's layout is the A operand's of the next
//     product once its k slots are read as keys 2 tig and 2 tig + 1: P and
//     dS go from registers to the split with no shuffle.
//   * Rows past T arrive as zeros from the copy; columns past hd are never
//     read (hd is a multiple of 8).
//   * GQA is read through the (B, T, heads, hd) strides: no copy.

#include "flash_wgmma.cuh"

namespace {

constexpr int kStages = 2;                 // ring depth
constexpr int kMaxSmem = 232448;           // per block on Hopper

// ---- split-TF32 products ---------------------------------------------------

// cvt.rna.tf32.f32 of a finite x: the magnitude rounded to 10 mantissa
// bits, ties away from zero, the low 13 bits cleared.  Two integer
// instructions: ptxas expands the PTX instruction into four (a compare and
// a select keep inf and NaN, which the products here never see), and the
// splits are most of this kernel's instructions.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// an A fragment (16 x 8) split into its TF32 halves
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_a(float x0, float x1, float x2,
                                        float x3, FragA& f) {
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32_rna(x[i]);
    f.lo[i] = tf32_rna(x[i] - __uint_as_float(f.hi[i]));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b over one 8-deep step, b = (b0, b1) the B fragment in fp32: big +=
// hi hi', small += lo hi' + hi lo'
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const FragA& a, float b0, float b1) {
  const uint32_t h0 = tf32_rna(b0), h1 = tf32_rna(b1);
  const uint32_t l0 = tf32_rna(b0 - __uint_as_float(h0));
  const uint32_t l1 = tf32_rna(b1 - __uint_as_float(h1));
  mma_tf32(small, a.lo, h0, h1);
  mma_tf32(big, a.hi, h0, h1);
  mma_tf32(small, a.hi, l0, l1);
}

// ---- swizzled tiles ---------------------------------------------------------

// element (r, c) of a tile of rows of HDP floats, the 16-byte chunks of row
// r XOR-swizzled by r & 7 (HDP a multiple of 32: within a 128-byte line)
template <int HDP>
__device__ __forceinline__ int sw(int r, int c) {
  return r * HDP + (c ^ ((r & 7) << 2));
}

// four 8 x 4 fp32 matrices from shared memory, one per 8 lanes' row
// addresses (16 bytes each): lane t gets word t % 4 of row t / 4 of each
__device__ __forceinline__ void ldsm4(uint32_t addr, float (&r)[4]) {
  uint32_t a, b, c, d;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
      : "r"(addr));
  r[0] = __uint_as_float(a);
  r[1] = __uint_as_float(b);
  r[2] = __uint_as_float(c);
  r[3] = __uint_as_float(d);
}

__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
                                            bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [t0, t0 + R) of one head of a (B, T, heads, hd) fp32 tensor into the
// swizzled tile s, by 16-byte copies; g points at (b, 0, head, 0), rows rs
// floats apart; rows at or past T are zero
template <int HDP, int R, int NTH>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          int64_t rs, int t0, int T, int hd) {
  const int cpr = hd >> 2;
  for (int i = threadIdx.x; i < R * cpr; i += NTH) {
    const int r = i / cpr, c = (i - r * cpr) << 2;
    const bool ok = t0 + r < T;
    cp_async16z(s + sw<HDP>(r, c), ok ? g + (int64_t)(t0 + r) * rs + c : g,
                ok);
  }
}

// sc[nt] = A[a0 + 16 rows] B[8 nt + 8 rows]^T over columns 8 ks0 ..
// 8 (ks0 + nks) - 1: the warp's 16 x 8 NT tile of a score-like product
// (or its part over those columns), both operands row-wise (K-major) in
// swizzled tiles at shared addresses A and Bm, their fragments by
// ldmatrix (A: lanes 0-15 rows a0 + lane, columns 0-3 of the step, lanes
// 16-31 columns 4-7; B: lanes 0-7 and 8-15 rows 0-7 of a 16-row pair,
// columns 0-3 and 4-7, lanes 16-31 rows 8-15); a0 a multiple of 8, NT
// even
template <int HDP, int NT>
__device__ __forceinline__ void qk_tile(float (&sc)[NT][4], uint32_t A,
                                        int a0, uint32_t Bm, int ks0,
                                        int nks, int lane) {
  float small[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = small[nt][e] = 0.f;
  const int xl = (lane & 7) << 2;             // the rows' swizzle
  const uint32_t a_row = A + 4 * (a0 + (lane & 15)) * HDP;
  const int a_col = 4 * (lane >> 4);
  const uint32_t b_row = Bm + 4 * ((lane & 7) + 8 * (lane >> 4)) * HDP;
  const int b_col = 4 * ((lane >> 3) & 1);
#pragma unroll 4
  for (int i = 0; i < nks; ++i) {
    const int ks = ks0 + i;
    float a[4];
    ldsm4(a_row + 4 * ((8 * ks + a_col) ^ xl), a);
    FragA fa;
    split_a(a[0], a[1], a[2], a[3], fa);
    const uint32_t b_at = b_row + 4 * ((8 * ks + b_col) ^ xl);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      float b[4];
      ldsm4(b_at + 4 * 16 * HDP * j, b);
      mma3(sc[2 * j], small[2 * j], fa, b[0], b[1]);
      mma3(sc[2 * j + 1], small[2 * j + 1], fa, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] += small[nt][e];
}

// acc[ct] += X Y[:, 8 (ct0 + ct) ..] for ct < nct: X (16 x 8 NT) in the
// score accumulator's layout, its k slots tig and tig + 4 of step kk read
// as rows 8 kk + 2 tig and 8 kk + 2 tig + 1 of Y (a swizzled tile, read
// transposed).  CG column tiles a pass, each in fresh accumulators added
// to acc in fp32.
template <int HDP, int NT, int CT>
__device__ __forceinline__ void pv_tile(float (&acc)[CT][4],
                                        const float (&x)[NT][4],
                                        const float* Y, int ct0, int nct,
                                        int g, int tig) {
  constexpr int CG = CT < 4 ? CT : 4;
  FragA fa[NT];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk)
    split_a(x[kk][0], x[kk][2], x[kk][1], x[kk][3], fa[kk]);
#pragma unroll
  for (int c0 = 0; c0 < CT; c0 += CG) {
    if (c0 >= nct) break;
    float big[CG][4], small[CG][4];
#pragma unroll
    for (int cc = 0; cc < CG; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[cc][e] = small[cc][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int r = 8 * kk + 2 * tig;
#pragma unroll
      for (int cc = 0; cc < CG; ++cc)
        if (c0 + cc < nct) {
          const int c = 8 * (ct0 + c0 + cc) + g;
          mma3(big[cc], small[cc], fa[kk], Y[sw<HDP>(r, c)],
               Y[sw<HDP>(r + 1, c)]);
        }
    }
#pragma unroll
    for (int cc = 0; cc < CG; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c0 + cc][e] += big[cc][e] + small[cc][e];
  }
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---- the work split ---------------------------------------------------------

// A block of NTH threads: two groups (0: the scores S, 1: dP) of HS parts
// of W warps, warp w of part hh owning rows 16 w .. 16 w + 15 of the item
// and columns part hh of hd in the score-like products.  HS = 2 at HDP
// 256, where 32-row items leave 4 warps otherwise.  FULL: hd == HDP, so
// every column count is a constant.
template <int HDP, int R, int HS, bool FULL>
struct Split {
  static constexpr int W = R / 16;
  static constexpr int NTH = 64 * W * HS;
  static constexpr int NT = R / 8;            // 8-column tiles of a score
  static constexpr int X = 2 * HS * R * R;    // exchange floats
  int lane, grp, hh, w, g, tig, nks, ks0, nct;
  __device__ __forceinline__ Split(int hd) {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    grp = warp / (W * HS);
    hh = warp / W - grp * HS;
    w = warp % W;
    g = lane >> 2;
    tig = lane & 3;
    nct = FULL ? HDP / 8 : hd >> 3;           // 8-column tiles of hd
    const int per = FULL ? HDP / 8 / HS : (nct + HS - 1) / HS;
    ks0 = hh * per;
    nks = FULL ? per : min(per, nct - ks0);
  }
  // the floats of this warp's part of group `which` in the exchange
  __device__ __forceinline__ int slot(int which, int part) const {
    return (((which * HS + part) * W + w) * NT * 32 + lane) * 4;
  }
};

// the whole score-like tile of this warp's rows, its HS parts summed in
// order from the exchange
template <int HS, int NT>
__device__ __forceinline__ void gather(float (&x)[NT][4], const float* X,
                                       int s0, int part_stride) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float4 a = load4(X + s0 + nt * 128);
    x[nt][0] = a.x;
    x[nt][1] = a.y;
    x[nt][2] = a.z;
    x[nt][3] = a.w;
#pragma unroll
    for (int p = 1; p < HS; ++p) {
      const float4 b = load4(X + s0 + p * part_stride + nt * 128);
      x[nt][0] += b.x;
      x[nt][1] += b.y;
      x[nt][2] += b.z;
      x[nt][3] += b.w;
    }
  }
}

// ---- (a) dq -----------------------------------------------------------------

// float offsets in dynamic shared memory
template <int HDP, int R, int HS>
struct DqLayout {
  static constexpr int kTile = R * HDP;
  static constexpr int kQ = 0;
  static constexpr int kDO = kTile;
  static constexpr int kRing = 2 * kTile;              // stage s: K, then V
  static constexpr int kX = kRing + kStages * 2 * kTile;   // S and dP parts
  static constexpr int kL = kX + 2 * HS * R * R;       // lse log2 e, R
  static constexpr int kD = kL + R;                    // D, R
  static constexpr int kTotal = kD + R;
};

template <int HDP, int R, int HS, bool FULL>
__global__ void __launch_bounds__(4 * R * HS, 1)
flash_bwd_tf32x3_dq_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ Dv, float* __restrict__ dq,
                           Dims d) {
  using S = Split<HDP, R, HS, FULL>;
  using L = DqLayout<HDP, R, HS>;
  constexpr int NTH = S::NTH, NT = S::NT;
  // dQ's columns in 2 HS parts: (group, hd part) takes one
  constexpr int CT = (HDP / 8 + 2 * HS - 1) / (2 * HS);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const S sp(d.hd);
  const int bh = blockIdx.x, b = bh / d.H, h = bh - b * d.H;
  const int kvh = h / (d.H / d.KV);
  const int nq = (d.Tq + R - 1) / R;
  const int q_lo = (nq - 1 - (int)blockIdx.y) * R;   // heavy causal first
  const int ldr = lse_rows(d.Tq);
  const int64_t rs = (int64_t)d.H * d.hd, rk = (int64_t)d.KV * d.hd;
  const int64_t qoff = (int64_t)b * d.Tq * rs + (int64_t)h * d.hd;
  const int64_t koff = (int64_t)b * d.Tk * rk + (int64_t)kvh * d.hd;
  // the key tiles [lo, hi) of the forward's relevance test
  const int nk = (d.Tk + R - 1) / R;
  const int hi = d.causal ? min(nk, (q_lo + R - 1) / R + 1) : nk;
  const int lo = d.window > 0 ? max(0, (q_lo - d.window + 1) / R) : 0;

  load_tile<HDP, R, NTH>(sm + L::kQ, q + qoff, rs, q_lo, d.Tq, d.hd);
  load_tile<HDP, R, NTH>(sm + L::kDO, dout + qoff, rs, q_lo, d.Tq, d.hd);
  if (lo < hi) {
    load_tile<HDP, R, NTH>(sm + L::kRing, k + koff, rk, lo * R, d.Tk, d.hd);
    load_tile<HDP, R, NTH>(sm + L::kRing + L::kTile, v + koff, rk, lo * R,
                           d.Tk, d.hd);
  }
  cp_async_commit();

  // D = rowsum(dO o), a warp a row, written for (b) on the rows below
  // lse_rows (0 past Tq); the rows' lse in log2 units (+inf past lse_rows)
  for (int r = threadIdx.x >> 5; r < R; r += NTH / 32) {
    const int t = q_lo + r;
    float acc = 0.f;
    if (t < d.Tq)
      for (int c = sp.lane; c < d.hd; c += 32)
        acc = fmaf(dout[qoff + t * rs + c], o[qoff + t * rs + c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sp.lane == 0) {
      sm[L::kD + r] = acc;
      if (t < ldr) Dv[(int64_t)bh * ldr + t] = acc;
    }
  }
  for (int r = threadIdx.x; r < R; r += NTH) {
    const int t = q_lo + r;
    sm[L::kL + r] = t < ldr ? lse[(int64_t)bh * ldr + t] * kLog2e
                            : __int_as_float(0x7f800000);
  }

  const int part = sp.grp * HS + sp.hh;
  const int per = FULL ? CT : (sp.nct + 2 * HS - 1) / (2 * HS);
  const int ct0 = part * per;
  const int my_ct = FULL ? CT : max(0, min(per, sp.nct - ct0));
  const int r0 = 16 * sp.w + sp.g;     // this thread's rows r0, r0 + 8
  const float scale_log2 = d.scale * kLog2e;
  float acc[CT][4];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ct][e] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int s = (kt - lo) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < hi) {
      float* nx = sm + L::kRing + (s ^ 1) * 2 * L::kTile;
      load_tile<HDP, R, NTH>(nx, k + koff, rk, (kt + 1) * R, d.Tk, d.hd);
      load_tile<HDP, R, NTH>(nx + L::kTile, v + koff, rk, (kt + 1) * R,
                             d.Tk, d.hd);
    }
    cp_async_commit();
    const int k_lo = kt * R;
    if (!any_live(q_lo, R, k_lo, R, d)) continue;
    const float* Ks = sm + L::kRing + s * 2 * L::kTile;
    const float* Vs = Ks + L::kTile;

    // group 0: S = Q K^T, group 1: dP = dO V^T, over hd part hh, to the
    // exchange
    float x[NT][4];
    qk_tile<HDP, NT>(x, smem_u32(sm + (sp.grp ? L::kDO : L::kQ)), 16 * sp.w,
                     smem_u32(sp.grp ? Vs : Ks), sp.ks0, sp.nks, sp.lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      store4(sm + L::kX + sp.slot(sp.grp, sp.hh) + nt * 128, x[nt]);
    __syncthreads();
    // every warp: S and dP of its rows, P, dS = P (dP - D)
    const int stride = S::W * NT * 128;
    float dp[NT][4];
    gather<HS, NT>(x, sm + L::kX, sp.slot(0, 0), stride);
    gather<HS, NT>(dp, sm + L::kX, sp.slot(1, 0), stride);
    const bool whole = all_live(q_lo, R, k_lo, R, d);
    const float m0 = sm[L::kL + r0], m1 = sm[L::kL + r0 + 8];
    const float D0 = sm[L::kD + r0], D1 = sm[L::kD + r0 + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(x[nt][e], scale_log2, -((e >> 1) ? m1 : m0)));
        if (!whole && !live(q_lo + r0 + 8 * (e >> 1),
                            k_lo + 8 * nt + 2 * sp.tig + (e & 1), d))
          p = 0.f;
        x[nt][e] = p * (dp[nt][e] - ((e >> 1) ? D1 : D0));
      }
    // dQ += dS K over this warp's columns
    pv_tile<HDP, NT, CT>(acc, x, Ks, ct0, my_ct, sp.g, sp.tig);
  }

#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
    if (ct < my_ct) {
      const int c = 8 * (ct0 + ct) + 2 * sp.tig;
      const int t = q_lo + r0;
      if (t < d.Tq)
        *reinterpret_cast<float2*>(dq + qoff + t * rs + c) =
            make_float2(acc[ct][0] * d.scale, acc[ct][1] * d.scale);
      if (t + 8 < d.Tq)
        *reinterpret_cast<float2*>(dq + qoff + (t + 8) * rs + c) =
            make_float2(acc[ct][2] * d.scale, acc[ct][3] * d.scale);
    }
}

// ---- (b) dkdv ---------------------------------------------------------------

template <int HDP, int R, int HS>
struct DkdvLayout {
  static constexpr int kTile = R * HDP;
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kRing = 2 * kTile;
  // a stage: Q, dO, then R lse and R D values
  static constexpr int kStage = 2 * kTile + 2 * R;
  static constexpr int kX = kRing + kStages * kStage;  // S^T and dP^T parts
  static constexpr int kTotal = kX + 2 * HS * R * R;
};

template <int HDP, int R, int HS, bool FULL>
__global__ void __launch_bounds__(4 * R * HS, 1)
flash_bwd_tf32x3_dkdv_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ Dv,
                             float* __restrict__ dk, float* __restrict__ dv,
                             Dims d) {
  using S = Split<HDP, R, HS, FULL>;
  using L = DkdvLayout<HDP, R, HS>;
  constexpr int NTH = S::NTH, NT = S::NT;
  // dV (group 0) or dK (group 1) columns in HS parts
  constexpr int CT = HDP / 8 / HS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const S sp(d.hd);
  const int bk = blockIdx.x, b = bk / d.KV, kvh = bk - b * d.KV;
  const int G = d.H / d.KV;
  const int k_lo = blockIdx.y * R;     // heavy causal tiles first
  const int ldr = lse_rows(d.Tq);
  const int64_t rs = (int64_t)d.H * d.hd, rk = (int64_t)d.KV * d.hd;
  const int64_t koff = (int64_t)b * d.Tk * rk + (int64_t)kvh * d.hd;
  // the R-query tiles that can see keys [k_lo, k_lo + R)
  const int t_lo = d.causal ? k_lo : 0;
  const int t_hi = d.window > 0 ? min(d.Tq, k_lo + R - 1 + d.window) : d.Tq;
  const int qt_lo = t_lo / R;
  const int nqt = t_lo < t_hi ? (t_hi + R - 1) / R - qt_lo : 0;
  const int n = G * nqt;               // (head, query tile) steps

  auto load_stage = [&](int j, int s) {
    const int h = kvh * G + j / nqt, t0 = (qt_lo + j % nqt) * R;
    const int64_t qoff = (int64_t)b * d.Tq * rs + (int64_t)h * d.hd;
    float* st = sm + L::kRing + s * L::kStage;
    load_tile<HDP, R, NTH>(st, q + qoff, rs, t0, d.Tq, d.hd);
    load_tile<HDP, R, NTH>(st + L::kTile, dout + qoff, rs, t0, d.Tq, d.hd);
    // lse and D rows t0 .. t0 + R - 1, all below lse_rows
    const int64_t row0 = ((int64_t)b * d.H + h) * ldr + t0;
    for (int i = threadIdx.x; i < R / 2; i += NTH) {
      const int which = i / (R / 4), c = 4 * (i - which * (R / 4));
      cp_async16z(st + 2 * L::kTile + which * R + c,
                  (which ? Dv : lse) + row0 + c, true);
    }
  };

  load_tile<HDP, R, NTH>(sm + L::kK, k + koff, rk, k_lo, d.Tk, d.hd);
  load_tile<HDP, R, NTH>(sm + L::kV, v + koff, rk, k_lo, d.Tk, d.hd);
  if (n > 0) load_stage(0, 0);
  cp_async_commit();

  const int ct0 = FULL ? sp.hh * CT : sp.ks0;
  const int my_ct = FULL ? CT : sp.nks;
  const int r0 = 16 * sp.w + sp.g;     // this thread's keys r0, r0 + 8
  const float scale_log2 = d.scale * kLog2e;
  float acc[CT][4];                    // dV (group 0) or dK (group 1)
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ct][e] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int s = j & 1;
    cp_async_wait_all();
    __syncthreads();   // step j landed; every warp is done with j - 1
    if (j + 1 < n) load_stage(j + 1, s ^ 1);
    cp_async_commit();
    const int t0 = (qt_lo + j % nqt) * R;
    if (!any_live(t0, R, k_lo, R, d)) continue;
    const float* Qs = sm + L::kRing + s * L::kStage;
    const float* dOs = Qs + L::kTile;
    const float* Ls = dOs + L::kTile;
    const float* Ds = Ls + R;

    // group 0: S^T = K Q^T, group 1: dP^T = V dO^T, over hd part hh, to
    // the exchange
    float x[NT][4];
    qk_tile<HDP, NT>(x, smem_u32(sm + (sp.grp ? L::kV : L::kK)), 16 * sp.w,
                     smem_u32(sp.grp ? dOs : Qs), sp.ks0, sp.nks, sp.lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      store4(sm + L::kX + sp.slot(sp.grp, sp.hh) + nt * 128, x[nt]);
    __syncthreads();
    // P^T of this warp's keys; group 1 also dS^T = P^T (dP^T - D)
    const int stride = S::W * NT * 128;
    gather<HS, NT>(x, sm + L::kX, sp.slot(0, 0), stride);
    const bool whole = all_live(t0, R, k_lo, R, d);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(Ls + 8 * nt + 2 * sp.tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(x[nt][e], scale_log2,
                           -(((e & 1) ? l2.y : l2.x) * kLog2e)));
        if (!whole && !live(t0 + 8 * nt + 2 * sp.tig + (e & 1),
                            k_lo + r0 + 8 * (e >> 1), d))
          p = 0.f;
        x[nt][e] = p;
      }
    }
    if (sp.grp == 1) {
      float dp[NT][4];
      gather<HS, NT>(dp, sm + L::kX, sp.slot(1, 0), stride);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 D2 =
            *reinterpret_cast<const float2*>(Ds + 8 * nt + 2 * sp.tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[nt][e] *= dp[nt][e] - ((e & 1) ? D2.y : D2.x);
      }
    }
    // dV += P^T dO (group 0), dK += dS^T Q (group 1)
    pv_tile<HDP, NT, CT>(acc, x, sp.grp ? Qs : dOs, ct0, my_ct, sp.g,
                         sp.tig);
  }

  float* out = sp.grp ? dk : dv;
  const float mul = sp.grp ? d.scale : 1.f;
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
    if (ct < my_ct) {
      const int c = 8 * (ct0 + ct) + 2 * sp.tig;
      const int j_ = k_lo + r0;
      if (j_ < d.Tk)
        *reinterpret_cast<float2*>(out + koff + j_ * rk + c) =
            make_float2(acc[ct][0] * mul, acc[ct][1] * mul);
      if (j_ + 8 < d.Tk)
        *reinterpret_cast<float2*>(out + koff + (j_ + 8) * rk + c) =
            make_float2(acc[ct][2] * mul, acc[ct][3] * mul);
    }
}

// ---- host side --------------------------------------------------------------

template <typename K>
int prepare_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HDP, int R, int HS, bool FULL>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* D, void* dq,
              const Dims& d, cudaStream_t s) {
  constexpr int smem = (int)sizeof(float) * DqLayout<HDP, R, HS>::kTotal;
  static_assert(smem <= kMaxSmem, "dq tiles exceed shared memory");
  constexpr int nth = Split<HDP, R, HS, FULL>::NTH;
  auto kernel = flash_bwd_tf32x3_dq_kernel<HDP, R, HS, FULL>;
  const int err = prepare_smem(kernel, smem);
  if (err) return err;
  const dim3 grid(d.B * d.H, (d.Tq + R - 1) / R);
  kernel<<<grid, nth, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (float*)D, (float*)dq, d);
  return (int)cudaGetLastError();
}

template <int HDP, int R, int HS, bool FULL>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* D, void* dk,
                void* dv, const Dims& d, cudaStream_t s) {
  constexpr int smem = (int)sizeof(float) * DkdvLayout<HDP, R, HS>::kTotal;
  static_assert(smem <= kMaxSmem, "dkdv tiles exceed shared memory");
  constexpr int nth = Split<HDP, R, HS, FULL>::NTH;
  auto kernel = flash_bwd_tf32x3_dkdv_kernel<HDP, R, HS, FULL>;
  const int err = prepare_smem(kernel, smem);
  if (err) return err;
  const dim3 grid(d.B * d.KV, (d.Tk + R - 1) / R);
  kernel<<<grid, nth, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)D, (float*)dk, (float*)dv, d);
  return (int)cudaGetLastError();
}

bool valid(const Dims& d) {
  return d.B > 0 && d.Tq > 0 && d.Tk > 0 && d.H > 0 && d.KV > 0 &&
         d.H % d.KV == 0 && d.hd > 0 && d.hd <= 256 && d.hd % 8 == 0 &&
         d.window >= 0 && (d.Tq + 31) / 32 <= 65535 &&
         (d.Tk + 31) / 32 <= 65535;
}

// F<HDP, R, HS, FULL> for the head dim: rows of HDP floats (hd rounded up
// to 64, 128 or 256), R rows a work item, hd in HS parts in the score
// products; FULL (every column count a constant: 10-14% faster on an
// H100 at hd 64 and 256, PERF.md) where hd is HDP, but for dkdv at HDP 128
// (F128 false), whose FULL instance reaches the 255-register limit and
// spills
#define REPRO_TF32X3_DISPATCH(F, F128, d, ...)                        \
  do {                                                                \
    if ((d).hd == 64) return F<64, 64, 1, true>(__VA_ARGS__);         \
    if ((d).hd < 64) return F<64, 64, 1, false>(__VA_ARGS__);         \
    if ((d).hd == 128) return F<128, 64, 1, F128>(__VA_ARGS__);       \
    if ((d).hd < 128) return F<128, 64, 1, false>(__VA_ARGS__);       \
    if ((d).hd == 256) return F<256, 32, 2, true>(__VA_ARGS__);       \
    return F<256, 32, 2, false>(__VA_ARGS__);                         \
  } while (0)

}  // namespace

// q, o, dout (B, Tq, H, hd) and k, v (B, Tk, KV, hd), fp32, contiguous and
// 16-byte aligned, hd a multiple of 8 up to 256; lse (B, H, lse_rows(Tq))
// fp32 from the fp32 forward; D (B, H, lse_rows(Tq)) fp32 scratch that this
// launch writes for the dkdv launch; dq (B, Tq, H, hd) fp32 output.
extern "C" int repro_flash_attention_bwd_tf32x3_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, int B, int Tq,
    int Tk, int H, int KV, int hd, int causal, int window, float scale,
    void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  REPRO_TF32X3_DISPATCH(launch_dq, true, d, q, k, v, o, dout, lse, D, dq,
                        d, (cudaStream_t)stream);
}

// dk, dv (B, Tk, KV, hd) fp32 outputs; lse and D as the dq launch took and
// wrote them, on the same stream after it.
extern "C" int repro_flash_attention_bwd_tf32x3_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dk, void* dv, int B, int Tq,
    int Tk, int H, int KV, int hd, int causal, int window, float scale,
    void* stream) {
  const Dims d{B, Tq, Tk, H, KV, hd, causal, window, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  REPRO_TF32X3_DISPATCH(launch_dkdv, false, d, q, k, v, dout, lse, D, dk,
                        dv, d, (cudaStream_t)stream);
}
