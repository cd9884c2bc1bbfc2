// Min-plus (tropical) matrix product for Hopper: out[i,j] = min_k A[i,k] + B[k,j].
//
// Replaces: src/repro/kernels/minplus.py:minplus_pallas, the Pallas TPU
// kernel that walks k-panels of +inf-padded (128, 16, 128) blocks and
// keeps a running minimum in the output block.
//
// Used by every APSP product of the main paths: the hub Bellman-Ford
// rounds (h, n) x (n, n) (h = 140 hubs at Crop, n = 19412), the hub
// composition (n, h) x (h, n), the approx path's panel sweep (512, h) x
// (h, n) and per-cluster blocks (m_c, h) x (h, m_c), and the exact
// squarings (n, n) x (n, n) below HUB_MIN_N.
//
// What bounds it on the card: the tropical semiring has no
// multiply-accumulate, so neither the tensor cores nor FMA apply.  Each
// (i, k, j) costs one fp32 add (FADD, the FMA pipe) and one fp32 min
// (FMNMX, the ALU pipe) on the CUDA cores: 2 instructions per triple at
// 128 lanes x 132 SMs x 1980 MHz, 33.45 T instructions/s.  The ALU pipe
// (64 lanes per SM) gives the same time if FMNMX issues there while FADD
// issues on the FMA pipe.  At (140, 19412) x (19412, 19412) that is
// 5.275e10 triples, 3.154 ms; the bytes (A, B and out once each, 1.5 GB)
// take 0.45 ms at 3.35 TB/s, so the kernel is bound by instructions, and
// the design spends as few as it can besides the FADD and the FMNMX.
//
// Design.  The tiles, stages and split were chosen by timing variants
// against each other on an NVIDIA H100 80GB HBM3 at 700 W:
//   * Tiles fitted to the hub shapes.  One block of 384 threads (12 warps;
//     ty = warp, tx = lane) owns a 144 x 256 output tile: one block row
//     covers all 140 hub rows (2.9% padded rows), so a hub round reads W
//     once.  Each thread keeps a 12 x 8 register tile of running minima,
//     rows {4 ty + r, 48 + 4 ty + r, 96 + 4 ty + r} and columns
//     {4 tx + c, 128 + 4 tx + c}, r, c < 4: 168 registers, one block per
//     SM, 3 warps on each of its 4 schedulers.  Blocks of 6 warps, two
//     per SM, were slower: 6 warps do not spread evenly over 4
//     schedulers, and a block waits at every panel barrier for the
//     scheduler that holds two of its warps.
//   * Operands by 16-byte shared loads.  A's panel is stored k-major,
//     As[k][row] (rows padded to 148 floats against bank conflicts), B's
//     as it lies in memory, Bs[k][col].  Per k a thread loads 3 LDS.128
//     of A (its rows are adjacent) and 2 of B for 96 triples: (192 + 5) /
//     96 = 2.05 issued instructions per triple.
//   * A 3-stage ring of 32-deep k-panels (155,136 bytes of shared memory)
//     filled by cp.async: A element by element (the 4-byte copies
//     transpose it), B in 16-byte chunks where its rows are 16-byte
//     aligned (n % 4 == 0 and aligned pointers), element by element
//     otherwise, never the old kernel.  The two B paths are two instances
//     of the kernel, so the 4-byte one costs the other no registers.  One
//     __syncthreads() per panel publishes the panel that landed and frees
//     the slot the next copy overwrites; the next panel's copies are in
//     flight under the current one's compute.  The copy state a thread
//     keeps through a tile is a row mask and A's source; B's source is
//     recomputed per panel, because holding it spilled a register.
//   * Split k where the tiles do not fill the card (stream-K).  If one
//     tile per block would leave more than a tenth of the last wave idle
//     (the hub round has 76 tiles for 132 SMs), the grid is one block per
//     SM and each block takes an equal run of the (tile, k-panel) units,
//     crossing tile boundaries.  A block that holds a whole tile stores
//     it; a block that holds part of one folds its partial minima into
//     out by an atomic min on the float's bits, after a fill of out with
//     +inf in the same call (one counted launch per product).  The
//     minimum of exactly rounded sums does not depend on its order, so
//     the split stays bitwise.  The composition's 10,260 tiles fill 78
//     waves and run one tile per block.
//   * Vectorised stores: st.global.cs.v4 where out's rows are 16-byte
//     aligned, scalar stores otherwise.
//   * Padding.  Rows past m and columns past n copy zeros (cp.async with
//     src-size 0); their outputs are never written, so a padded value
//     never meets a kept output.  k past the end is never read: the last
//     panel's loop stops at the real k, so no padded pair is summed.
//
// SASS (cuobjdump -sass, CUDA 12.8), each of the two instances: 480 FMNMX
// and 480 FADD, 25 LDS.128 and no other shared load that executes (the
// scalar LDS in the listing are ptxas's never-taken "@!PT LDS RZ, [RZ]"),
// no LDL or STL (chip_smoke.py).  On an NVIDIA H100 80GB HBM3 at 700 W
// the hub round takes 4.30-4.34 ms, 73% of its 3.154 ms bound, where the
// same FADD/FMNMX loop alone, with no copies and no barriers, reaches
// 81.5% (tools/minplus_bench.py, tools/minplus_ceiling.cu; PERF.md).
//
// Bitwise the plain version's (ref.minplus_ref): each sum is __fadd_rn
// and each min is PTX min.NaN.f32 (one FMNMX), which returns NaN when
// either operand is NaN (fminf would drop it), so a NaN input reaches
// every output it is summed into.  The atomic fold orders non-NaN floats
// by their bits (signed min for a clear sign bit, unsigned max for a set
// one) and stores NaN as 0xffffffff, which both orders keep; -0 and +0
// fold to -0.  The kernel never writes into A or B (apsp_exact squares D
// into a fresh buffer).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 144;          // output rows per tile
constexpr int kBN = 256;          // output columns per tile
constexpr int kBK = 32;           // k-panel depth
constexpr int kStages = 3;        // k-panels in the ring
constexpr int kThreads = 384;     // 12 x 32 threads, 12 warps
constexpr int kMinBlocks = 1;     // blocks per SM the registers must allow
constexpr int kTM = 12;           // rows per thread
constexpr int kTN = 8;            // columns per thread
constexpr int kTX = kBN / kTN;    // threads across a tile row
constexpr int kRowStep = 4 * (kBM / kTM);   // 48: a thread's row groups
constexpr int kColStep = 4 * kTX;           // 128: its column groups
constexpr int kAP = kBM + 4;      // k-major A panel row, padded for banks
constexpr int kAFloats = kBK * kAP;
constexpr int kStageFloats = kAFloats + kBK * kBN;
constexpr int kSmemBytes = kStages * kStageFloats * 4;
constexpr int kMinPanels = 4;     // least k-panels a split block takes
constexpr unsigned kNanBits = 0xffffffffu;
// copies of one panel per thread: A element by element, kARows rows
// apart; B in 16-byte chunks, kBRows k apart, or element by element
constexpr int kACopies = kBM * kBK / kThreads;
constexpr int kARows = kThreads / kBK;
constexpr int kBChunks = kBK * kBN / 4;
constexpr int kBCopies = (kBChunks + kThreads - 1) / kThreads;
constexpr int kBRows = kThreads / (kBN / 4);
constexpr int kBScalarCopies = (kBK * kBN + kThreads - 1) / kThreads;

static_assert(kThreads == (kBM / kTM) * kTX, "thread grid");
static_assert(kThreads % 32 == 0 && kTX % 4 == 0, "whole warps");
static_assert((kBM * kBK) % kThreads == 0 && kThreads % kBK == 0,
              "A copies per thread");
static_assert(kThreads % (kBN / 4) == 0, "B chunks per thread");

struct Args {
  const float* A;
  const float* B;
  float* out;
  int m, k, n;
  int tiles_n;          // column tiles
  int panels;           // k-panels per tile
  long long units;      // tiles * panels, below 2^31
};

// The tile a block is working on, as one thread copies it: which of its
// A rows lie below m (bit q: row i0 + t / kBK + kARows q), where its A
// copies start, and whether its B columns lie below n.  B's source is
// recomputed per panel: holding it too spills a register.
struct Tile {
  int i0, j0;
  unsigned a_rows;
  const float* a;       // &A[i0 + t / kBK][t % kBK]
  bool b_cols;          // the thread's B chunk lies below n (vector path)
};

// min(a, b) that returns NaN if either operand is NaN (sm_80 and later)
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// cp.async of 4 or 16 bytes; !valid writes zeros and reads nothing of src
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Atomic out[i] = min_nan(out[i], v) on a float that started at +inf.
__device__ __forceinline__ void atomic_min_nan(float* p, float v) {
  const unsigned u = __float_as_uint(v);
  if (v != v)
    atomicMax(reinterpret_cast<unsigned*>(p), kNanBits);
  else if ((int)u >= 0)
    atomicMin(reinterpret_cast<int*>(p), (int)u);
  else
    atomicMax(reinterpret_cast<unsigned*>(p), u);
}

__device__ __forceinline__ Tile make_tile(const Args& a, int tile, int t) {
  Tile c;
  c.i0 = tile / a.tiles_n * kBM;
  c.j0 = tile % a.tiles_n * kBN;
  c.a_rows = 0;
#pragma unroll
  for (int q = 0; q < kACopies; ++q)
    if (c.i0 + t / kBK + kARows * q < a.m) c.a_rows |= 1u << q;
  c.a = a.A + (long long)(c.i0 + t / kBK) * a.k + t % kBK;
  const int cb = c.j0 + 4 * (t % (kBN / 4));
  c.b_cols = cb < a.n;
  return c;
}

// Copy k-panel p of a tile into one stage of the ring.  An element past
// m, n or k is not read: its copy writes zeros (rows and columns past the
// edge reach no kept output; k past the end is never read back).
template <bool kVec>
__device__ __forceinline__ void load_panel(const Args& a, const Tile& c,
                                           float* As, int p, int t) {
  float* Bs = As + kAFloats;
  const int k0 = p * kBK;
  {
    // A (m, k) into the k-major As[k][row]
    const bool kin = k0 + t % kBK < a.k;
    const float* src = c.a + k0;
    float* dst = As + (t % kBK) * kAP + t / kBK;
    const long long step = (long long)kARows * a.k;
#pragma unroll
    for (int q = 0; q < kACopies; ++q) {
      const bool ok = kin && ((c.a_rows >> q) & 1u);
      cp_async4(dst + kARows * q, ok ? src + q * step : a.A, ok);
    }
  }
  if (kVec) {
    const int kk = t / (kBN / 4), cb = 4 * (t % (kBN / 4));
    const float* src = a.B + (long long)(k0 + kk) * a.n + c.j0 + cb;
    float* dst = Bs + kk * kBN + cb;
    const long long step = (long long)kBRows * a.n;
#pragma unroll
    for (int q = 0; q < kBCopies; ++q) {
      if ((q + 1) * kThreads <= kBChunks || t < kBChunks - q * kThreads) {
        const bool ok = c.b_cols && k0 + kk + kBRows * q < a.k;
        cp_async16(dst + kBRows * q * kBN, ok ? src + q * step : a.B, ok);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kBScalarCopies; ++q) {
      const int idx = t + kThreads * q;
      if (idx < kBK * kBN) {
        const int gk = k0 + idx / kBN, gj = c.j0 + idx % kBN;
        const bool ok = gk < a.k && gj < a.n;
        cp_async4(Bs + idx, ok ? a.B + (long long)gk * a.n + gj : a.B, ok);
      }
    }
  }
}

// The thread's (row, column) in the tile of its accumulator (R, C).
__device__ __forceinline__ int tile_row(int R, int ty) {
  return kRowStep * (R >> 2) + 4 * ty + (R & 3);
}
__device__ __forceinline__ int tile_col(int C, int tx) {
  return kColStep * (C >> 2) + 4 * tx + (C & 3);
}

// Fold one k of a staged panel into acc: arow and brow are the thread's
// first operands in that k's row of A and of B.
__device__ __forceinline__ void compute_k(const float* arow,
                                          const float* brow,
                                          float (&acc)[kTM][kTN]) {
  float av[kTM], bv[kTN];
#pragma unroll
  for (int q = 0; q < kTM / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(arow + kRowStep * q);
    av[4 * q] = v.x; av[4 * q + 1] = v.y;
    av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < kTN / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(brow + kColStep * q);
    bv[4 * q] = v.x; bv[4 * q + 1] = v.y;
    bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int R = 0; R < kTM; ++R)
#pragma unroll
    for (int C = 0; C < kTN; ++C)
      acc[R][C] = min_nan(acc[R][C], __fadd_rn(av[R], bv[C]));
}

template <bool kVec>
__device__ __forceinline__ void store_tile(const Args& a,
                                           const float (&acc)[kTM][kTN],
                                           int i0, int j0, int tx, int ty,
                                           bool whole) {
#pragma unroll
  for (int R = 0; R < kTM; ++R) {
    const int gi = i0 + tile_row(R, ty);
    if (gi >= a.m) continue;
    float* orow = a.out + (long long)gi * a.n;
#pragma unroll
    for (int h = 0; h < kTN / 4; ++h) {
      const int gj = j0 + tile_col(4 * h, tx);
      const float* v = &acc[R][4 * h];
      if (!whole) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gj + c < a.n) atomic_min_nan(orow + gj + c, v[c]);
      } else if (kVec) {
        if (gj < a.n)
          __stcs(reinterpret_cast<float4*>(orow + gj),
                 make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gj + c < a.n) orow[gj + c] = v[c];
      }
    }
  }
}

// kVec: B's and out's rows are 16-byte aligned (n % 4 == 0, aligned
// pointers), so B is copied and out stored 16 bytes at a time.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
minplus_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int tx = t % kTX;
  const int ty = t / kTX;
  // this block's run of (tile, k-panel) units
  int u = (int)(a.units * blockIdx.x / gridDim.x);
  const int u_end = (int)(a.units * (blockIdx.x + 1) / gridDim.x);
  while (u < u_end) {
    const int tile = u / a.panels;
    const int p0 = u - tile * a.panels;
    const int p1 = min(a.panels, p0 + (u_end - u));
    const Tile c = make_tile(a, tile, t);

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (p0 + s < p1)
        load_panel<kVec>(a, c, smem + s * kStageFloats, p0 + s, t);
      cp_async_commit();
    }
    float acc[kTM][kTN];
#pragma unroll
    for (int R = 0; R < kTM; ++R)
#pragma unroll
      for (int C = 0; C < kTN; ++C) acc[R][C] = INFINITY;
    int slot = 0;
    for (int p = p0; p < p1; ++p) {
      cp_async_wait<kStages - 2>();   // panel p has landed (this thread's)
      __syncthreads();                // ... every thread's; p - 1's slot free
      const int nxt = p + kStages - 1;
      const int nslot = slot == 0 ? kStages - 1 : slot - 1;
      if (nxt < p1)
        load_panel<kVec>(a, c, smem + nslot * kStageFloats, nxt, t);
      cp_async_commit();
      const float* As = smem + slot * kStageFloats + 4 * ty;
      const float* Bs = smem + slot * kStageFloats + kAFloats + 4 * tx;
      const int kend = min(kBK, a.k - p * kBK);
#pragma unroll 4
      for (int kk = 0; kk < kend; ++kk)
        compute_k(As + kk * kAP, Bs + kk * kBN, acc);
      slot = slot == kStages - 1 ? 0 : slot + 1;
    }
    cp_async_wait<0>();
    __syncthreads();                  // the ring is free for the next tile
    store_tile<kVec>(a, acc, c.i0, c.j0, tx, ty, p0 == 0 && p1 == a.panels);
    u += p1 - p0;
  }
}

__global__ void fill_inf_kernel(float* out, long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride)
    out[i] = INFINITY;
}

struct DeviceInfo {
  int sms;
  int blocks_per_sm;    // of the least-occupied kernel instance
};

constexpr int kMaxDevices = 64;
DeviceInfo g_info[kMaxDevices];

cudaError_t device_info(DeviceInfo* info) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_info[dev];
  if (d.sms == 0) {
    int blocks = 1 << 30;
    void (*const kernels[2])(Args) = {minplus_kernel<true>,
                                      minplus_kernel<false>};
    for (auto kernel : kernels) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
      if (e != cudaSuccess) return e;
      int b = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads,
                                                        kSmemBytes);
      if (e != cudaSuccess) return e;
      if (b < blocks) blocks = b;
    }
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    d.blocks_per_sm = blocks > 0 ? blocks : 1;
    d.sms = sms > 0 ? sms : 1;
  }
  *info = d;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int repro_minplus(const void* A, const void* B, void* out, int m,
                             int k, int n, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;

  Args a;
  a.A = (const float*)A;
  a.B = (const float*)B;
  a.out = (float*)out;
  a.m = m;
  a.k = k;
  a.n = n;
  const long long tiles_m = (m + kBM - 1) / kBM;
  const long long tiles_n = (n + kBN - 1) / kBN;
  const long long tiles = tiles_m * tiles_n;
  a.tiles_n = (int)tiles_n;
  a.panels = (k + kBK - 1) / kBK;
  a.units = tiles * a.panels;
  // the kernel counts units in int: 2^31 of them would need A, B and out
  // far beyond one card's memory
  if (a.units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(B) && aligned16(out);

  // One tile per block unless that leaves more than a tenth of the last
  // wave's block slots idle; then one block per slot, k split (stream-K).
  const long long slots = (long long)info.sms * info.blocks_per_sm;
  const long long waves = (tiles + slots - 1) / slots;
  long long grid = tiles;
  if (10 * tiles < 9 * waves * slots) {
    grid = (a.units + kMinPanels - 1) / kMinPanels;
    if (grid > slots) grid = slots;
  }
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (grid != tiles) {
    // partial tiles fold into out by atomic min: start from +inf
    const long long count = (long long)m * n;
    long long fill_blocks = (count + 255) / 256;
    if (fill_blocks > 8LL * info.sms) fill_blocks = 8LL * info.sms;
    fill_inf_kernel<<<(unsigned)fill_blocks, 256, 0, s>>>(a.out, count);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (vec)
    minplus_kernel<true><<<(unsigned)grid, kThreads, kSmemBytes, s>>>(a);
  else
    minplus_kernel<false><<<(unsigned)grid, kThreads, kSmemBytes, s>>>(a);
  return (int)cudaGetLastError();
}
