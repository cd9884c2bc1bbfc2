// Write patterns of an (n, n) fp32 output on the card, for
// tools/dense_kernels_bench.py --store-probe.  Each writes every element
// once with st.global.cs.v4 (n % 4 == 0), from a persistent grid:
//   0  grid-stride over the whole array (a memset's pattern);
//   1  128 x 128 tiles, row-major over the tile grid, one warp store per
//      512-byte row piece of a tile;
//   2  the same tiles, a warp store = 4 rows x 128 bytes (8 lanes a row);
//   3  the same tiles, a warp store = 8 rows x 64 bytes (4 lanes a row).
// With n % 8 == 4 every other row starts 16 bytes into a 32-byte sector,
// so the tiles' row pieces begin and end inside sectors; with n % 8 == 0
// they begin and end on sector boundaries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int MODE>
__global__ void __launch_bounds__(256, 2) store_kernel(float* out, int n,
                                                       int nb) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float4 v = make_float4(1.f, 2.f, 3.f, (float)t);
  if (MODE == 0) {
    const int64_t total = (int64_t)n * n / 4;
    for (int64_t i = (int64_t)blockIdx.x * 256 + t; i < total;
         i += (int64_t)gridDim.x * 256)
      __stcs(reinterpret_cast<float4*>(out) + i, v);
    return;
  }
  for (int tile = blockIdx.x; tile < nb * nb; tile += gridDim.x) {
    const int i0 = tile / nb * 128, j0 = tile % nb * 128;
    // lanes per row piece: 32, 8 or 4; rows per store: 1, 4 or 8
    constexpr int per_row = MODE == 1 ? 32 : MODE == 2 ? 8 : 4;
    constexpr int rows = 32 / per_row;
    const int rr = lane / per_row, cc = (lane % per_row) * 4;
    for (int r = warp * rows + rr; r < 128; r += 8 * rows)
      for (int c = cc; c < 128; c += per_row * 4) {
        const int gi = i0 + r, gj = j0 + c;
        if (gi < n && gj < n)
          __stcs(reinterpret_cast<float4*>(out + (int64_t)gi * n + gj), v);
      }
  }
}

}  // namespace

extern "C" int dense_store_probe(void* out, int n, int mode, int grid,
                                 void* stream) {
  if (n % 4 != 0 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const int nb = (n + 127) / 128;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  switch (mode) {
    case 0: store_kernel<0><<<grid, 256, 0, s>>>(o, n, nb); break;
    case 1: store_kernel<1><<<grid, 256, 0, s>>>(o, n, nb); break;
    case 2: store_kernel<2><<<grid, 256, 0, s>>>(o, n, nb); break;
    default: store_kernel<3><<<grid, 256, 0, s>>>(o, n, nb); break;
  }
  return (int)cudaGetLastError();
}
