// K1: the DIA SpMV  y = A x  and its residual form  y = b - A x.
//
// Replaces tpuamg/sparse/dia_pallas.py:_spmv_kernel (the outer operator of
// every PCG iteration, via PDIA.matvec) and :_residual_kernel (PDIA.residual;
// here also the t-pass of every Chebyshev step and the level residual of
// the V-cycle in vcycle.cu's host sequence).  Its padded-x entry also
// replaces tpuamg/sparse/pallas_kernels.py:_dia_kernel and the SpMV and
// residual calls of tpuamg/dist/pallas_dist.py:ShardedPDIA.
//
// Bound on an H100: bytes.  Each row does 2 flops per diagonal against
// 4 (f32) or 2 (bf16) plane bytes, far below the card's ~20 flop/byte
// balance point for float32 FMA, so the least time is
// (nd * n * plane_bytes + 4 n [x] + 4 n [y] (+ 4 n [b])) / 3.35 TB/s.
// Design for that bound: one thread per row, planes stored diagonal-major
// so that every plane is read exactly once, fully coalesced; x is re-read
// nd times but at shifted windows of one contiguous vector, which L1/L2
// absorb.  The TPU kernel's 128-lane roll/select shift decomposition and
// its VMEM block pipeline have no counterpart: a shifted read is a plain
// address offset here.
#include "dia_sweep.cuh"

namespace tpuamg {

template <typename P>
__global__ void __launch_bounds__(kThreads)
dia_sweep_kernel(const P* __restrict__ planes, const float* __restrict__ x,
                 const float* __restrict__ b, float* __restrict__ y,
                 long long n, long long x_pad, Offsets of) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float acc = dia_row_padded(planes, x, n, x_pad, i, of);
  y[i] = b != nullptr ? __ldg(b + i) - acc : acc;
}

inline int dia_sweep(const void* planes, int planes_bf16, const void* x,
                     const void* b, void* y, long long n, long long x_pad,
                     int nd, const int* offsets, void* stream) {
  if (nd < 0 || nd > kMaxDiags || x_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Offsets of = make_offsets(nd, offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (planes_bf16) {
    dia_sweep_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(planes), xf, bf, yf, n, x_pad, of);
  } else {
    dia_sweep_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(planes), xf, bf, yf, n, x_pad, of);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpuamg

// y = A x (b == NULL) or y = b - A x.  planes: (nd, n) diagonal-major,
// float32 (planes_bf16 == 0) or bfloat16 (planes_bf16 == 1).  Returns the
// cudaGetLastError() of the launch.
extern "C" int tpuamg_dia_sweep(const void* planes, int planes_bf16,
                                const void* x, const void* b, void* y,
                                long long n, int nd, const int* offsets,
                                void* stream) {
  return tpuamg::dia_sweep(planes, planes_bf16, x, b, y, n, 0, nd, offsets,
                           stream);
}

// The padded-x entry: as tpuamg_dia_sweep, but x has n + 2 x_pad entries
// and row i of the operator reads x[i + x_pad + off[d]] (zero outside the
// buffer).  It serves a row shard whose halos were exchanged into the
// buffer's ends (dist/dist_kernels.py), and the whole-vector SpMV over a
// zero-padded x that replaces tpuamg/sparse/pallas_kernels.py:_dia_kernel.
extern "C" int tpuamg_dia_sweep_pad(const void* planes, int planes_bf16,
                                    const void* x, long long x_pad,
                                    const void* b, void* y, long long n,
                                    int nd, const int* offsets,
                                    void* stream) {
  return tpuamg::dia_sweep(planes, planes_bf16, x, b, y, n, x_pad, nd,
                           offsets, stream);
}
