// Shared pieces of the DIA (multi-diagonal) sweeps of dia.cu and vcycle.cu.
//
// A DIA operator over n rows is nd planes stored diagonal-major,
// planes[d * n + i] = A[i, i + off[d]], in float32 or bfloat16.  One
// thread owns one row: for every diagonal it reads its own plane entry
// (neighbouring threads read neighbouring addresses, so each plane
// streams through coalesced) and x[i + off[d]] (a shifted contiguous
// window of x, served mostly from L1/L2 because the offsets of one
// operator span a few thousand entries).  Indices outside [0, n) read 0,
// which is what the zero halo of the TPU layout gave; the padded form
// reads x from a buffer with x_pad halo entries on each side instead.
// Sums are float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpuamg {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;

struct Offsets {
  int nd;
  int o[kMaxDiags];
};

inline Offsets make_offsets(int nd, const int* host_offsets) {
  Offsets of;
  of.nd = nd;
  for (int d = 0; d < kMaxDiags; ++d) of.o[d] = d < nd ? host_offsets[d] : 0;
  return of;
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

// sum_d planes[d, i] * x[i + x_pad + off[d]], float32 accumulation, over
// an x of nx = n + 2 x_pad entries whose row i sits at i + x_pad (a row
// shard with its halos); reads outside [0, nx) give 0
template <typename P>
__device__ __forceinline__ float dia_row_padded(const P* __restrict__ planes,
                                                const float* __restrict__ x,
                                                long long n, long long x_pad,
                                                long long i,
                                                const Offsets& of) {
  const long long nx = n + 2 * x_pad;
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < of.nd; ++d) {
    const long long j = i + x_pad + of.o[d];
    const float xv = (j >= 0 && j < nx) ? __ldg(x + j) : 0.f;
    acc = fmaf(load_f32(planes, static_cast<long long>(d) * n + i), xv, acc);
  }
  return acc;
}

// sum_d planes[d, i] * x[i + off[d]], float32 accumulation
template <typename P>
__device__ __forceinline__ float dia_row(const P* __restrict__ planes,
                                         const float* __restrict__ x,
                                         long long n, long long i,
                                         const Offsets& of) {
  return dia_row_padded(planes, x, n, 0, i, of);
}

}  // namespace tpuamg
