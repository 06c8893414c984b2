// K3's earlier design: a whole Chebyshev smoother sweep on one level of
// the unfused grid hierarchy as 2k + 1 launches from one C call.  K3 is
// now csrc/cheb_persistent.cu, one cooperative launch per application;
// this file stays only so that the card can time the two designs side by
// side (sparse/dia_kernels.py::cheb_sweep_sequenced, its own launch count;
// no route calls it).
//
// Replaces tpuamg/sparse/dia_pallas.py:_cheb_kernel (via _cheb_call and
// FusedChebSmoother.smooth / .smooth_residual), which runs the sweep as ONE
// program on one TPU core: x, b, t and d stay in VMEM while the A and C
// planes stream block by block.  Here each step's two passes are separate
// grid-wide launches: the C-apply of row i reads t at C's offsets, and a
// launch has no barrier between blocks.  For the C the port builds (the
// nodal block inverse, offsets -(F-1)..F-1 and zero across node blocks)
// those reads stay inside row i's node block, which is what lets the
// persistent kernels run a step as one pass; this design takes any C and
// either storage type for each of A and C.  The host-side loop lives in
// C (one ctypes call per smoother application), so Python pays one call
// for 2k+1 launches (and the wrapper a copy of x).
//
// Per step, on the interleaved flat layout of length n (no padding;
// out-of-range reads give 0, as dia_row does):
//   t = b - A x                          (cheb_t_kernel)
//   first step:  d = C t / theta,  else d = a_k d + c_k C t;  x += d
//                                        (cheb_d_kernel)
// and with want_r one more pass r = b - A x_final.
//
// Bound on an H100: bytes.  Each pass does 2 flops per diagonal against 4
// (f32) or 2 (bf16) plane bytes, far below the card's float32 balance
// point, so the least time of the function is its inputs read once and
// its outputs written once over 3.35 TB/s; the algorithm itself streams
// the A planes degree*iters (+1) times and the C planes degree*iters
// times.  Design for that bound: one thread per row, planes
// diagonal-major so every plane streams coalesced once per pass, the
// shifted x / t reads served by L1/L2.  x, b, t and d are float32; the
// planes float32 or bfloat16 with float32 sums.
#include "dia_sweep.cuh"

namespace tpuamg {

constexpr int kMaxDegree = 16;

template <typename P>
__global__ void __launch_bounds__(kThreads)
cheb_t_kernel(const P* __restrict__ planes, const float* __restrict__ x,
              const float* __restrict__ b, float* __restrict__ t, long long n,
              Offsets of) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  t[i] = __ldg(b + i) - dia_row(planes, x, n, i, of);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
cheb_d_kernel(const P* __restrict__ cplanes, const float* __restrict__ t,
              float* __restrict__ d, float* __restrict__ x, long long n,
              Offsets of, int first, float s, float c) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ct = dia_row(cplanes, t, n, i, of);
  const float dn = first ? s * ct : s * d[i] + c * ct;
  d[i] = dn;
  x[i] += dn;
}

template <typename P>
cudaError_t launch_t(const void* planes, const float* x, const float* b,
                     float* t, long long n, const Offsets& of,
                     cudaStream_t st) {
  cheb_t_kernel<P><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const P*>(planes), x, b, t, n, of);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_d(const void* cplanes, const float* t, float* d, float* x,
                     long long n, const Offsets& of, int first, float s,
                     float c, cudaStream_t st) {
  cheb_d_kernel<P><<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const P*>(cplanes), t, d, x, n, of, first, s, c);
  return cudaGetLastError();
}

}  // namespace tpuamg

// The sweep: iters x degree steps on x (updated in place), then
// r = b - A x when r != NULL.  A: ndA planes (bf16 if A_bf16), C: ndC
// planes (bf16 if C_bf16), both (nd, n) diagonal-major.  t, d: float32
// scratch of n entries.  coefs: a_k, c_k for k = 1..degree-1,
// interleaved.  Returns the first cudaGetLastError() that is not success.
extern "C" int tpuamg_cheb_sweep(const void* A, int A_bf16, int ndA,
                                 const int* offsA, const void* C, int C_bf16,
                                 int ndC, const int* offsC, void* x,
                                 const void* b, void* t, void* d, void* r,
                                 long long n, int degree, int iters,
                                 float inv_theta, const float* coefs,
                                 void* stream) {
  using namespace tpuamg;
  if (ndA < 0 || ndA > kMaxDiags || ndC < 0 || ndC > kMaxDiags ||
      degree < 1 || degree > kMaxDegree || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Offsets ofA = make_offsets(ndA, offsA);
  const Offsets ofC = make_offsets(ndC, offsC);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  const float* bf = static_cast<const float*>(b);
  float* tf = static_cast<float*>(t);
  float* df = static_cast<float*>(d);
  cudaError_t e = cudaSuccess;
  for (int it = 0; it < iters; ++it) {
    for (int k = 0; k < degree; ++k) {
      e = A_bf16 ? launch_t<__nv_bfloat16>(A, xf, bf, tf, n, ofA, st)
                 : launch_t<float>(A, xf, bf, tf, n, ofA, st);
      if (e != cudaSuccess) return static_cast<int>(e);
      const int first = k == 0;
      const float s = first ? inv_theta : coefs[2 * (k - 1)];
      const float c = first ? 0.f : coefs[2 * (k - 1) + 1];
      e = C_bf16
              ? launch_d<__nv_bfloat16>(C, tf, df, xf, n, ofC, first, s, c, st)
              : launch_d<float>(C, tf, df, xf, n, ofC, first, s, c, st);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  if (r != nullptr) {
    float* rf = static_cast<float*>(r);
    e = A_bf16 ? launch_t<__nv_bfloat16>(A, xf, bf, rf, n, ofA, st)
               : launch_t<float>(A, xf, bf, rf, n, ofA, st);
  }
  return static_cast<int>(e);
}
