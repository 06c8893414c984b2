// K1's wide entry: y = A x and y = b - A x for a DIA operator of any band
// count, walked through the tile-compacted layout of its nonzeros that
// tpuamg_torch/sparse/dia_tiles.py builds once per operator.
//
// Replaces tpuamg/sparse/dia_pallas.py:_spmv_kernel and :_residual_kernel
// at the band counts of the structured 3D-1D path (behind maybe_pdia,
// tpuamg/amg/structured.py:910-912, 944-948, 1097-1098, 1108-1109;
// dia_max_offsets=1024): the factored outer operator's AD, StructuredOp's
// DIA part and the Chebyshev steps of wide window levels.
//
// Bound on an H100: bytes.  The function needs the operator's nonzero
// values, x and y (and b) once: (nnz * value bytes + 4 n (2 [+ 1])) /
// 3.35 TB/s; at 2 flops per 5-6 streamed bytes it is far from the f32
// flop bound.  The padded planes hold 25-40x more bytes than the nonzeros
// at the structured path's band counts (205-463 bands, 3-4% fill), so
// the layout streams only the nonzeros: per tile of T rows, the bands the
// tile uses (their offsets, int32), and per row its nonzeros as (local
// band index, value) pairs, sliced-ELL within the tile, kGroup entries of
// a row side by side.
//
// Design: one thread per row, so that a row's sum is the same chain of
// fmaf in stored diagonal order as the planes kernel's (dia.cu,
// dia_wide_kernel), less the exact zeros: the two agree bit for bit for
// finite x.  Each step loads kGroup values and kGroup indices of the
// thread's row with one vector load each (a warp's loads are
// contiguous), the next group's pair is loaded before the current one is
// summed, and x is read through the read-only path at
// i + tile_off[band_ptr[tile] + index].  Padding entries (value 0) read
// nothing.  The block size is the caller's (THREADS of dia_tiles.py):
// 256 measured fastest at every structured size, even where it leaves
// SMs idle (55 blocks at 13,912 rows), because a launch there is one
// row's chain of dependent loads long, not a matter of SM count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuamg {

constexpr int kGroup = 4;           // GROUP of sparse/dia_tiles.py
constexpr int kMaxTileThreads = 256;

struct Group {
  float v[kGroup];
  int k[kGroup];
};

__device__ __forceinline__ void load_values(const float* p, long long e,
                                            Group& g) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p + e));
  g.v[0] = f.x;
  g.v[1] = f.y;
  g.v[2] = f.z;
  g.v[3] = f.w;
}

// bfloat16 -> float32 is the 16 bits moved up, as __bfloat162float does
__device__ __forceinline__ void load_values(const __nv_bfloat16* p,
                                            long long e, Group& g) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + e));
  g.v[0] = __uint_as_float(u.x << 16);
  g.v[1] = __uint_as_float(u.x & 0xffff0000u);
  g.v[2] = __uint_as_float(u.y << 16);
  g.v[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void load_index(const uint8_t* p, long long e,
                                           Group& g) {
  const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(p + e));
  g.k[0] = w & 0xff;
  g.k[1] = (w >> 8) & 0xff;
  g.k[2] = (w >> 16) & 0xff;
  g.k[3] = w >> 24;
}

__device__ __forceinline__ void load_index(const uint16_t* p, long long e,
                                           Group& g) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p + e));
  g.k[0] = w.x & 0xffff;
  g.k[1] = w.x >> 16;
  g.k[2] = w.y & 0xffff;
  g.k[3] = w.y >> 16;
}

template <typename P, typename I>
__device__ __forceinline__ void load_group(const P* vals, const I* idx,
                                           long long e, Group& g) {
  load_values(vals, e, g);
  load_index(idx, e, g);
}

template <typename P, typename I>
__global__ void __launch_bounds__(kMaxTileThreads)
dia_tiles_kernel(const P* __restrict__ vals, const I* __restrict__ idx,
                 const long long* __restrict__ ent_ptr,
                 const int* __restrict__ band_ptr,
                 const int* __restrict__ tile_off, int rows,
                 const float* __restrict__ x, const float* __restrict__ b,
                 float* __restrict__ y, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;                 // no barrier follows
  const long long t = i / rows;
  const long long lane = i - t * rows;
  const long long step = static_cast<long long>(kGroup) * rows;
  const long long e0 = __ldg(ent_ptr + t);
  const int groups = static_cast<int>((__ldg(ent_ptr + t + 1) - e0) / step);
  const int* __restrict__ boff = tile_off + __ldg(band_ptr + t);
  const float* __restrict__ xi = x + i;
  long long e = e0 + kGroup * lane;
  float acc = 0.f;
  Group cur, next;
  if (groups > 0) load_group(vals, idx, e, next);
  for (int g = 0; g < groups; ++g) {
    cur = next;
    e += step;
    if (g + 1 < groups) load_group(vals, idx, e, next);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (cur.v[q] != 0.f)
        acc = fmaf(cur.v[q], __ldg(xi + __ldg(boff + cur.k[q])), acc);
    }
  }
  y[i] = b != nullptr ? __ldg(b + i) - acc : acc;
}

template <typename P, typename I>
inline void launch(const void* vals, const void* idx,
                   const long long* ent_ptr, const int* band_ptr,
                   const int* tile_off, int rows, const float* x,
                   const float* b, float* y, long long n, int threads,
                   cudaStream_t s) {
  const unsigned int blocks =
      static_cast<unsigned int>((n + threads - 1) / threads);
  dia_tiles_kernel<P, I><<<blocks, threads, 0, s>>>(
      static_cast<const P*>(vals), static_cast<const I*>(idx), ent_ptr,
      band_ptr, tile_off, rows, x, b, y, n);
}

}  // namespace tpuamg

namespace tpuamg {
// The layout's argument array (host memory): the pointers and types of
// the layout, in this order (DiaTiles.kernel_args).
enum LayoutArg {
  kVals, kValsBf16, kIdx, kIdxBytes, kEntPtr, kBandPtr, kTileOff, kRows, kN
};
}  // namespace tpuamg

// y = A x (b == NULL) or y = b - A x from the layout: layout[kVals]
// (float32 when layout[kValsBf16] == 0, bfloat16 when 1) and
// layout[kIdx] (layout[kIdxBytes] 1: uint8, 2: uint16), both aligned to
// kGroup entries; ent_ptr (tiles + 1, int64), band_ptr (tiles + 1,
// int32), tile_off (int32) device arrays; rows per tile; n rows; threads
// per block a multiple of 32 up to 256.  Returns the cudaGetLastError()
// of the launch.
extern "C" int tpuamg_dia_tiles(const long long* layout, const void* x,
                                const void* b, void* y, int threads,
                                void* stream) {
  using namespace tpuamg;
  const int bf16 = static_cast<int>(layout[kValsBf16]);
  const int idx_bytes = static_cast<int>(layout[kIdxBytes]);
  const int rows = static_cast<int>(layout[kRows]);
  const long long n = layout[kN];
  if (rows <= 0 || threads <= 0 || threads % 32 ||
      threads > kMaxTileThreads || (idx_bytes != 1 && idx_bytes != 2) ||
      n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* vals = reinterpret_cast<const void*>(layout[kVals]);
  const void* idx = reinterpret_cast<const void*>(layout[kIdx]);
  const long long* ep = reinterpret_cast<const long long*>(layout[kEntPtr]);
  const int* bp = reinterpret_cast<const int*>(layout[kBandPtr]);
  const int* to = reinterpret_cast<const int*>(layout[kTileOff]);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (bf16) {
    if (idx_bytes == 1)
      launch<__nv_bfloat16, uint8_t>(vals, idx, ep, bp, to, rows, xf, bf, yf,
                                     n, threads, s);
    else
      launch<__nv_bfloat16, uint16_t>(vals, idx, ep, bp, to, rows, xf, bf,
                                      yf, n, threads, s);
  } else {
    if (idx_bytes == 1)
      launch<float, uint8_t>(vals, idx, ep, bp, to, rows, xf, bf, yf, n,
                             threads, s);
    else
      launch<float, uint16_t>(vals, idx, ep, bp, to, rows, xf, bf, yf, n,
                              threads, s);
  }
  return static_cast<int>(cudaGetLastError());
}
