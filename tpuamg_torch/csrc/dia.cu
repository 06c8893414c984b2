// K1: the DIA SpMV  y = A x  and its residual form  y = b - A x.
//
// Replaces tpuamg/sparse/dia_pallas.py:_spmv_kernel (the outer operator of
// every PCG iteration, via PDIA.matvec) and :_residual_kernel (PDIA.residual;
// here also the t-pass of every Chebyshev step and the level residual of
// the V-cycle in vcycle.cu's host sequence).  The unpadded entry also
// replaces tpuamg/sparse/pallas_kernels.py:_dia_kernel (its zero-padded x
// is what the bounds checks give), and the padded-x entry the SpMV and
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

// The planes design of K1's wide entry, kept for comparison on the card
// (sparse/dia_kernels.py:dia_spmv_wide_planes; no route launches it: the
// wide entry is dia_tiles.cu, which reads only the nonzeros and equals
// this kernel bit for bit).  Any band count.  The offsets stay in a
// device int32 array that the caller uploads; every block stages them in
// shared memory, kWideTile at a time (8 KB), and each thread loops over
// them for its row, in the stored diagonal order, as dia_row does.  The
// row loop is the same as the <=64 entry's; only where the offsets live
// differs (kernel parameters hold 4 KB at most, and Offsets by value
// would cost every launch of the <=64 entry that space).  Threads past
// the last row stay to the end, because every thread of a block meets
// each tile's barriers.  It streams every padded plane: nd * n *
// plane_bytes, 25-40x the nonzeros at the structured path's band counts.
constexpr int kWideTile = 2048;

template <typename P>
__global__ void __launch_bounds__(kThreads)
dia_wide_kernel(const P* __restrict__ planes, const float* __restrict__ x,
                const float* __restrict__ b, float* __restrict__ y,
                long long n, int nd, const int* __restrict__ offsets) {
  __shared__ int s_off[kWideTile];
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool row = i < n;
  float acc = 0.f;
  for (int base = 0; base < nd; base += kWideTile) {
    const int m = min(kWideTile, nd - base);
    __syncthreads();
    for (int d = threadIdx.x; d < m; d += blockDim.x)
      s_off[d] = offsets[base + d];
    __syncthreads();
    if (!row) continue;
#pragma unroll 4
    for (int d = 0; d < m; ++d) {
      const long long j = i + s_off[d];
      const float xv = (j >= 0 && j < n) ? __ldg(x + j) : 0.f;
      acc = fmaf(load_f32(planes, static_cast<long long>(base + d) * n + i),
                 xv, acc);
    }
  }
  if (row) y[i] = b != nullptr ? __ldg(b + i) - acc : acc;
}

inline int dia_sweep_wide(const void* planes, int planes_bf16,
                          const void* x, const void* b, void* y, long long n,
                          int nd, const int* dev_offsets, void* stream) {
  if (nd < 0 || (nd > 0 && dev_offsets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (planes_bf16) {
    dia_wide_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(planes), xf, bf, yf, n, nd,
        dev_offsets);
  } else {
    dia_wide_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(planes), xf, bf, yf, n, nd, dev_offsets);
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
// buffer's ends (dist/dist_kernels.py).
extern "C" int tpuamg_dia_sweep_pad(const void* planes, int planes_bf16,
                                    const void* x, long long x_pad,
                                    const void* b, void* y, long long n,
                                    int nd, const int* offsets,
                                    void* stream) {
  return tpuamg::dia_sweep(planes, planes_bf16, x, b, y, n, x_pad, nd,
                           offsets, stream);
}

// The planes design of the wide entry (any nd; comparison only): as
// tpuamg_dia_sweep, but the offsets are a DEVICE array of nd int32
// values, read by every block into shared memory, kWideTile at a time.
extern "C" int tpuamg_dia_sweep_wide(const void* planes, int planes_bf16,
                                     const void* x, const void* b, void* y,
                                     long long n, int nd,
                                     const int* dev_offsets, void* stream) {
  return tpuamg::dia_sweep_wide(planes, planes_bf16, x, b, y, n, nd,
                                dev_offsets, stream);
}
