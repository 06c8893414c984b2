// K6: one Chebyshev step on a row shard whose x carries its halos.
//
// Replaces tpuamg/dist/pallas_dist.py:_cheb_step_kernel (via
// _cheb_step_call and ShardedChebSmoother.smooth / .smooth_residual).  The
// distributed smoother makes degree such steps per application, with a halo
// exchange before each, so every A-application sees fresh neighbour rows
// and the sharded sweep computes the single-device polynomial exactly.
//
// One step, on a shard of n rows with x_h = [halo | x | halo], h entries
// of halo on each side (zeros at the edges of the matrix):
//   t     = b - A x_h                    (A: ndA planes, any offsets <= h)
//   d_out = C t / theta  (first step)  or  a d_in + c C t
//   x_out = x + d_out
// C is the masked block inverse of the F x F node blocks
// (sparse/dia_kernels.py:blockinv_dia): offsets -(F-1)..F-1, and a C row
// never reads t across its node block.
//
// Design: one launch per step.  A CUDA block owns a tile of rows whose
// start and length are multiples of F.  Its threads compute t for the tile
// into shared memory (the t-pass: each thread one row, A planes
// diagonal-major and coalesced, the shifted x_h reads served by L1/L2),
// then apply C from shared memory, because no C row of the tile reads t
// outside it, and write d_out and x_out.  So, unlike K3 (cheb.cu), which
// needs two launches per step because its C-apply may read t across a
// block edge, nothing here depends on another block.  d_in and d_out may be
// the same buffer (each row reads and writes its own entry); x_out must not
// overlap x_h, whose neighbouring rows other blocks still read.
//
// Bound on an H100: bytes.  Each row does 2 flops per diagonal against 4
// (f32) or 2 (bf16) plane bytes, far below the card's float32 balance
// point, so the least time is
//   ((ndA + ndC) n s + 4 (n + 2h) [x_h] + 4 n [b, d_in, x_out, d_out])
// over 3.35 TB/s (s = plane bytes).  Sums are float32.
#include "dia_sweep.cuh"

namespace tpuamg {

template <typename PA, typename PC>
__global__ void __launch_bounds__(kThreads)
cheb_step_kernel(const PA* __restrict__ A, const PC* __restrict__ C,
                 const float* __restrict__ xh, const float* __restrict__ b,
                 const float* d_in, float* __restrict__ x_out, float* d_out,
                 long long n, long long h, int tile, Offsets ofA,
                 Offsets ofC, int first, float s, float c) {
  __shared__ float ts[kThreads];
  const int li = threadIdx.x;
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long i = start + li;
  const bool own = li < tile && i < n;
  ts[li] = own ? __ldg(b + i) - dia_row_padded(A, xh, n, h, i, ofA) : 0.f;
  __syncthreads();
  if (!own) return;
  float ct = 0.f;
#pragma unroll 4
  for (int d = 0; d < ofC.nd; ++d) {
    const int j = li + ofC.o[d];
    const float tv = (j >= 0 && j < tile) ? ts[j] : 0.f;
    ct = fmaf(load_f32(C, static_cast<long long>(d) * n + i), tv, ct);
  }
  const float dn = first ? s * ct : s * d_in[i] + c * ct;
  d_out[i] = dn;
  x_out[i] = __ldg(xh + h + i) + dn;
}

template <typename PA, typename PC>
cudaError_t launch_step(const void* A, const void* C, const float* xh,
                        const float* b, const float* d_in, float* x_out,
                        float* d_out, long long n, long long h, int tile,
                        const Offsets& ofA, const Offsets& ofC, int first,
                        float s, float c, cudaStream_t st) {
  const unsigned int blocks = static_cast<unsigned int>((n + tile - 1) / tile);
  cheb_step_kernel<PA, PC><<<blocks, kThreads, 0, st>>>(
      static_cast<const PA*>(A), static_cast<const PC*>(C), xh, b, d_in,
      x_out, d_out, n, h, tile, ofA, ofC, first, s, c);
  return cudaGetLastError();
}

}  // namespace tpuamg

// One step.  A: ndA planes (bf16 if A_bf16), C: ndC planes (bf16 if
// C_bf16), both (nd, n) diagonal-major over the shard's n rows; every A
// offset within [-h, h], every C offset within [-(F-1), F-1].  xh: n + 2h
// float32; b, d_in, x_out, d_out: n float32.  first != 0: d = s C t (s =
// 1/theta), else d = s d_in + c C t (s = a_k, c = c_k).  Returns the
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// arguments outside these limits.
extern "C" int tpuamg_cheb_step(const void* A, int A_bf16, int ndA,
                                const int* offsA, const void* C, int C_bf16,
                                int ndC, const int* offsC, const void* xh,
                                long long h, const void* b, const void* d_in,
                                void* x_out, void* d_out, long long n, int F,
                                int first, float s, float c, void* stream) {
  using namespace tpuamg;
  if (ndA < 0 || ndA > kMaxDiags || ndC < 0 || ndC > kMaxDiags || F < 1 ||
      F > kThreads || h < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < ndA; ++d)
    if (offsA[d] > h || offsA[d] < -h)
      return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < ndC; ++d)
    if (offsC[d] >= F || offsC[d] <= -F)
      return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Offsets ofA = make_offsets(ndA, offsA);
  const Offsets ofC = make_offsets(ndC, offsC);
  const int tile = kThreads - kThreads % F;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(xh);
  const float* bf = static_cast<const float*>(b);
  const float* di = static_cast<const float*>(d_in);
  float* xo = static_cast<float*>(x_out);
  float* dout = static_cast<float*>(d_out);
  cudaError_t e;
  if (A_bf16 && C_bf16)
    e = launch_step<__nv_bfloat16, __nv_bfloat16>(
        A, C, xf, bf, di, xo, dout, n, h, tile, ofA, ofC, first, s, c, st);
  else if (A_bf16)
    e = launch_step<__nv_bfloat16, float>(A, C, xf, bf, di, xo, dout, n, h,
                                          tile, ofA, ofC, first, s, c, st);
  else if (C_bf16)
    e = launch_step<float, __nv_bfloat16>(A, C, xf, bf, di, xo, dout, n, h,
                                          tile, ofA, ofC, first, s, c, st);
  else
    e = launch_step<float, float>(A, C, xf, bf, di, xo, dout, n, h, tile,
                                  ofA, ofC, first, s, c, st);
  return static_cast<int>(e);
}
