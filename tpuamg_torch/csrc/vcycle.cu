// K2: the pieces of one whole multigrid cycle  z = M b  on the padded grid
// hierarchy, launched level by level from the host (amg/grid_fused.py).
//
// Replaces tpuamg/amg/grid_fused.py:_mega_kernel and :_cycle_machine, which
// run the whole cycle as ONE sequential program on one TPU core.  Here the
// cycle is a short host-sequenced series of grid-wide launches on PyTorch's
// stream, with no barrier between blocks inside any launch (a kernel that
// waits on other blocks deadlocks when they are not all resident).  Per
// level visit: degree x (t-pass [dia.cu residual form] + cheb_apply) for
// pre- and post-smoothing, one residual, one restriction, one
// prolongation; at the bottom one coarse GEMV and its reduction.
//
// Bound on an H100: bytes.  Every piece is a stream over planes or vectors
// with at most a few flops per byte:
//   - cheb_apply: the (2F-1)-offset block-inverse DIA applied to t, then
//     d = C t / theta  or  d = a d + c C t,  x += d, fused so that d and x
//     are read and written once per step;
//   - restrict: pair sums over every leading axis and over x-node pairs of
//     one field (what the TPU kernel's 0/1 W0/W1 lane matmuls encode),
//     computed as index arithmetic, one thread per coarse entry;
//   - prolong: x += M * (duplicated coarse correction), one thread per fine
//     entry, the inverse index map of restrict;
//   - coarse_gemv: x_c = T^T-blocked dense solve over the (rows_c, nc, 128)
//     T in bf16 or f32 with f32 sums.  T is the largest single read of a
//     cycle, so the GEMV is split over nc into nsplit column chunks to put
//     rows_c * nsplit blocks in flight; thread l of block (R, s) reads
//     T[R, m, l] for its m range (128 consecutive entries per m: coalesced)
//     and a second launch sums the nsplit partials in a fixed order, so the
//     result does not depend on scheduling.
// Vectors are float32; planes, the mask and T come in the storage type.
#include "dia_sweep.cuh"

namespace tpuamg {

constexpr int kLanes = 128;

struct Lead {
  int nlead;    // number of leading (non-lane) grid axes, 1..3
  int c[3];     // COARSE leading dims; the fine ones are exactly 2x
};

template <typename P>
__global__ void __launch_bounds__(kThreads)
cheb_apply_kernel(const P* __restrict__ cplanes, const float* __restrict__ t,
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

__global__ void __launch_bounds__(kThreads)
restrict_kernel(const float* __restrict__ t, float* __restrict__ bc,
                long long nout, Lead lead, int K, int Kc, int F) {
  const long long ic =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ic >= nout) return;
  const int row_c = Kc * kLanes;       // lanes of one coarse grid row
  const int row_f = K * kLanes;        // lanes of one fine grid row
  const long long clex = ic / row_c;
  const int L = static_cast<int>(ic % row_c);
  const int f = L % F;
  const int cx = L / F;
  int cc[3] = {0, 0, 0};
  long long rem = clex;
  for (int a = lead.nlead - 1; a >= 0; --a) {
    cc[a] = static_cast<int>(rem % lead.c[a]);
    rem /= lead.c[a];
  }
  float acc = 0.f;
  for (int e = 0; e < (1 << lead.nlead); ++e) {
    long long flex = 0;
    for (int a = 0; a < lead.nlead; ++a)
      flex = flex * (2 * lead.c[a]) + 2 * cc[a] + ((e >> a) & 1);
    const float* trow = t + flex * row_f;
    for (int ex = 0; ex < 2; ++ex) {
      const int lf = (2 * cx + ex) * F + f;
      if (lf < row_f) acc += __ldg(trow + lf);
    }
  }
  bc[ic] = acc;
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
prolong_kernel(float* __restrict__ x, const P* __restrict__ mask,
               const float* __restrict__ xc, long long nfine, Lead lead,
               int K, int Kc, int F) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nfine) return;
  const int row_f = K * kLanes;
  const long long flex = i / row_f;
  const int lf = static_cast<int>(i % row_f);
  const int L = (lf / F / 2) * F + lf % F;
  long long rem = flex, clex = 0, mult = 1;
  for (int a = lead.nlead - 1; a >= 0; --a) {
    const int fc = static_cast<int>(rem % (2 * lead.c[a]));
    rem /= 2 * lead.c[a];
    clex += (fc / 2) * mult;
    mult *= lead.c[a];
  }
  x[i] += load_f32(mask, i) * __ldg(xc + clex * Kc * kLanes + L);
}

template <typename P>
__global__ void __launch_bounds__(kLanes)
coarse_gemv_kernel(const P* __restrict__ T, const float* __restrict__ bc,
                   float* __restrict__ partial, int nc, int chunk) {
  const int R = blockIdx.x;
  const int s = blockIdx.y;
  const int l = threadIdx.x;
  const int m0 = s * chunk;
  const int m1 = min(nc, m0 + chunk);
  const P* col = T + static_cast<long long>(R) * nc * kLanes + l;
  float acc0 = 0.f, acc1 = 0.f;
  int m = m0;
  for (; m + 1 < m1; m += 2) {
    acc0 = fmaf(load_f32(col, static_cast<long long>(m) * kLanes),
                __ldg(bc + m), acc0);
    acc1 = fmaf(load_f32(col, static_cast<long long>(m + 1) * kLanes),
                __ldg(bc + m + 1), acc1);
  }
  if (m < m1)
    acc0 = fmaf(load_f32(col, static_cast<long long>(m) * kLanes),
                __ldg(bc + m), acc0);
  partial[static_cast<long long>(s) * nc + R * kLanes + l] = acc0 + acc1;
}

__global__ void __launch_bounds__(kThreads)
coarse_reduce_kernel(const float* __restrict__ partial, float* __restrict__ xc,
                     int nc, int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nc) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s)
    acc += partial[static_cast<long long>(s) * nc + i];
  xc[i] = acc;
}

inline Lead make_lead(int nlead, const int* coarse_lead) {
  Lead g;
  g.nlead = nlead;
  for (int a = 0; a < 3; ++a) g.c[a] = a < nlead ? coarse_lead[a] : 1;
  return g;
}

}  // namespace tpuamg

// One Chebyshev C-apply with its direction and iterate update:
//   first:  d = s * (C t)            (s = 1 / theta)
//   else:   d = s * d + c * (C t)    (s = a_k, c = c_k)
//   then    x += d.
extern "C" int tpuamg_cheb_apply(const void* cplanes, int planes_bf16,
                                 const void* t, void* d, void* x,
                                 long long n, int nd, const int* offsets,
                                 int first, float s, float c, void* stream) {
  using namespace tpuamg;
  if (nd < 0 || nd > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Offsets of = make_offsets(nd, offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tf = static_cast<const float*>(t);
  float* df = static_cast<float*>(d);
  float* xf = static_cast<float*>(x);
  if (planes_bf16) {
    cheb_apply_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(cplanes), tf, df, xf, n, of, first,
        s, c);
  } else {
    cheb_apply_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
        static_cast<const float*>(cplanes), tf, df, xf, n, of, first, s, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// bc (prod(coarse_lead) * Kc * 128) = R t, t fine (prod(2 coarse_lead) * K
// * 128).
extern "C" int tpuamg_restrict(const void* t, void* bc, long long nout,
                               int nlead, const int* coarse_lead, int K,
                               int Kc, int F, void* stream) {
  using namespace tpuamg;
  if (nlead < 1 || nlead > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (nout <= 0) return static_cast<int>(cudaSuccess);
  restrict_kernel<<<blocks_for(nout), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<float*>(bc), nout,
      make_lead(nlead, coarse_lead), K, Kc, F);
  return static_cast<int>(cudaGetLastError());
}

// x (nfine) += mask * P xc.
extern "C" int tpuamg_prolong(void* x, const void* mask, int mask_bf16,
                              const void* xc, long long nfine, int nlead,
                              const int* coarse_lead, int K, int Kc, int F,
                              void* stream) {
  using namespace tpuamg;
  if (nlead < 1 || nlead > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (nfine <= 0) return static_cast<int>(cudaSuccess);
  const Lead lead = make_lead(nlead, coarse_lead);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  const float* xcf = static_cast<const float*>(xc);
  if (mask_bf16) {
    prolong_kernel<__nv_bfloat16><<<blocks_for(nfine), kThreads, 0, st>>>(
        xf, static_cast<const __nv_bfloat16*>(mask), xcf, nfine, lead, K, Kc,
        F);
  } else {
    prolong_kernel<float><<<blocks_for(nfine), kThreads, 0, st>>>(
        xf, static_cast<const float*>(mask), xcf, nfine, lead, K, Kc, F);
  }
  return static_cast<int>(cudaGetLastError());
}

// partial (nsplit, nc): partial[s, R*128 + l] = sum_{m in chunk s}
// T[R, m, l] * bc[m]; T is (rows_c, nc, 128), nc = rows_c * 128.
extern "C" int tpuamg_coarse_gemv(const void* T, int t_bf16, const void* bc,
                                  void* partial, int rows_c, int nc,
                                  int nsplit, void* stream) {
  using namespace tpuamg;
  if (rows_c <= 0 || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (nc + nsplit - 1) / nsplit;
  const dim3 grid(rows_c, nsplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bcf = static_cast<const float*>(bc);
  float* pf = static_cast<float*>(partial);
  if (t_bf16) {
    coarse_gemv_kernel<__nv_bfloat16><<<grid, kLanes, 0, st>>>(
        static_cast<const __nv_bfloat16*>(T), bcf, pf, nc, chunk);
  } else {
    coarse_gemv_kernel<float><<<grid, kLanes, 0, st>>>(
        static_cast<const float*>(T), bcf, pf, nc, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// xc[i] = sum_s partial[s, i], s in order.
extern "C" int tpuamg_coarse_reduce(const void* partial, void* xc, int nc,
                                    int nsplit, void* stream) {
  using namespace tpuamg;
  if (nc <= 0) return static_cast<int>(cudaSuccess);
  coarse_reduce_kernel<<<blocks_for(nc), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(xc), nc, nsplit);
  return static_cast<int>(cudaGetLastError());
}
