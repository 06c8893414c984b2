// K5, the earlier design: the PCG iteration of the chunked fused PCG,
// around K2's cycle.  The card's chunk is now one persistent launch
// (pcg_persistent.cu); this sequence stays to time it beside that one
// (amg/grid_fused.py::pcg_chunk_sequenced; no route takes it).
//
// Replaces tpuamg/amg/grid_fused.py:_pcg_kernel (via _pcg_call,
// FusedPCG.run_chunk and pcg_fused), which runs `chunk` whole PCG
// iterations -- dot products, the outer SpMV, the vector updates and the
// V-cycle -- as ONE program on one TPU core, carrying the scalars in
// registers from one phase to the next.  Here blocks run in parallel and
// in no order, so every reduction crosses a launch boundary: each
// iteration is three grid-wide launches plus K2's cycle, sequenced on
// PyTorch's stream by amg/grid_fused.py::pcg_chunk_sequenced, and no scalar
// leaves the card inside a chunk:
//   pcg_rz:  per-block partials of r.z
//   pcg_pq:  rz from the partials; beta = rz / rz_prev (0 while
//            rz_prev <= 0); p_new = z + beta p_old; q = Q p_new with the
//            float32 outer planes Q; per-block partials of p_new.q
//   pcg_xr:  alpha = rz / (p.q + tiny); x += alpha p; r -= alpha q;
//            per-block partials of |r|^2 and |x|^2
//   then z = M r by K2 (r is the cycle's right-hand side), and after the
//   chunk's last iteration one more pcg_rz and pcg_finish (one block).
// Scalars live in device memory: rzbuf[0] is the rz carried into the
// chunk (-1 on the first chunk: beta = 0), rzbuf[it + 1] the rz of
// iteration it; the stats rows (chunk + 1, 128) take the JAX package's
// layout, row it = (alpha, beta, sqrt|rz|, |r|, |x|) with row it's beta
// and sqrt|rz| those of the next r.z, row chunk = (rz_T, rz_last).  Block 0
// of pcg_pq writes row it-1 (beta, sqrt|rz| and the norms from pcg_xr's
// partials), pcg_xr writes alpha, pcg_finish the last row and row chunk.
//
// Deterministic reductions: a producer runs a fixed grid of
// min(ceil(n / 256), kMaxParts) blocks over a grid-stride loop and writes
// one partial per block; every consumer block re-reduces all partials in
// the same fixed order (strided per-thread sums, then a shared-memory
// tree), so all blocks and all runs get the same bits.  No float atomics.
//
// The TPU kernel updates p in place (recompute-from-old with a one-block
// write lag).  On the GPU a block reading p at i + off_d while another
// block writes p there is a race, so p is double-buffered: pcg_pq reads
// p_old at the neighbouring offsets and writes p_new, and the host swaps
// the two buffers every iteration.
//
// Bound on an H100: bytes.  Per iteration these launches stream r, z
// (rz), z, p_old, the ndQ float32 Q planes, p_new, q (pq) and x, r, p, q
// (xr), a few flops per byte.
#include "dia_sweep.cuh"

namespace tpuamg {

constexpr int kMaxParts = 512;     // = MAX_PARTS in amg/grid_fused.py
constexpr int kStatsLanes = 128;   // = STATS_LANES
constexpr float kTiny = 1e-30f;

inline int parts_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxParts ? (b > 0 ? b : 1) : kMaxParts);
}

// Sum over the block of v, by a fixed tree; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

// parts[0] + ... + parts[np - 1] in a fixed order: the same in every block.
__device__ __forceinline__ float reduce_parts(const float* parts, int np,
                                              float* sh) {
  float v = 0.f;
  for (int i = threadIdx.x; i < np; i += kThreads) v += parts[i];
  return block_sum(v, sh);
}

__global__ void __launch_bounds__(kThreads)
pcg_rz_kernel(const float* __restrict__ r, const float* __restrict__ z,
              float* __restrict__ parts, long long n) {
  __shared__ float sh[kThreads];
  float acc = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads)
    acc = fmaf(__ldg(r + i), __ldg(z + i), acc);
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) parts[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
pcg_pq_kernel(const float* __restrict__ Q, const float* __restrict__ z,
              const float* __restrict__ p_old, float* __restrict__ p_new,
              float* __restrict__ q, long long n, Offsets of,
              const float* __restrict__ rz_parts,
              float* __restrict__ pq_parts,
              const float* __restrict__ norm_parts, float* rzbuf, int it,
              float* stats) {
  __shared__ float sh[kThreads];
  const int np = gridDim.x;
  const float rz = reduce_parts(rz_parts, np, sh);
  const float rz_prev = rzbuf[it];
  const float beta = rz_prev > 0.f ? rz / (rz_prev + kTiny) : 0.f;
  float acc = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    float qi = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < of.nd; ++dd) {
      const long long j = i + of.o[dd];
      const float pj =
          (j >= 0 && j < n) ? fmaf(beta, __ldg(p_old + j), __ldg(z + j))
                            : 0.f;
      qi = fmaf(__ldg(Q + static_cast<long long>(dd) * n + i), pj, qi);
    }
    const float pi = fmaf(beta, __ldg(p_old + i), __ldg(z + i));
    p_new[i] = pi;
    q[i] = qi;
    acc = fmaf(pi, qi, acc);
  }
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) pq_parts[blockIdx.x] = s;
  if (blockIdx.x == 0) {
    if (it > 0) {
      // close row it-1: the previous pcg_xr's norms, this r.z's beta
      const float rn = reduce_parts(norm_parts, np, sh);
      const float xn = reduce_parts(norm_parts + kMaxParts, np, sh);
      if (threadIdx.x == 0) {
        float* row = stats + static_cast<long long>(it - 1) * kStatsLanes;
        row[1] = beta;
        row[2] = sqrtf(fabsf(rz));
        row[3] = sqrtf(rn);
        row[4] = sqrtf(xn);
      }
    }
    if (threadIdx.x == 0) rzbuf[it + 1] = rz;
  }
}

__global__ void __launch_bounds__(kThreads)
pcg_xr_kernel(float* __restrict__ x, float* __restrict__ r,
              const float* __restrict__ p, const float* __restrict__ q,
              long long n, const float* __restrict__ pq_parts,
              const float* __restrict__ rzbuf, int it,
              float* __restrict__ norm_parts, float* __restrict__ stats) {
  __shared__ float sh[kThreads];
  const int np = gridDim.x;
  const float pq = reduce_parts(pq_parts, np, sh);
  const float alpha = rzbuf[it + 1] / (pq + kTiny);
  float rn = 0.f, xn = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float xi = fmaf(alpha, __ldg(p + i), x[i]);
    const float ri = fmaf(-alpha, __ldg(q + i), r[i]);
    x[i] = xi;
    r[i] = ri;
    rn = fmaf(ri, ri, rn);
    xn = fmaf(xi, xi, xn);
  }
  const float sr = block_sum(rn, sh);
  const float sx = block_sum(xn, sh);
  if (threadIdx.x == 0) {
    norm_parts[blockIdx.x] = sr;
    norm_parts[kMaxParts + blockIdx.x] = sx;
    if (blockIdx.x == 0)
      stats[static_cast<long long>(it) * kStatsLanes] = alpha;
  }
}

__global__ void __launch_bounds__(kThreads)
pcg_finish_kernel(const float* __restrict__ rz_parts,
                  const float* __restrict__ norm_parts, int np,
                  const float* __restrict__ rzbuf, int chunk,
                  float* __restrict__ stats) {
  __shared__ float sh[kThreads];
  const float rz_t = reduce_parts(rz_parts, np, sh);
  const float rn = reduce_parts(norm_parts, np, sh);
  const float xn = reduce_parts(norm_parts + kMaxParts, np, sh);
  if (threadIdx.x == 0) {
    const float rz_last = rzbuf[chunk];
    float* row = stats + static_cast<long long>(chunk - 1) * kStatsLanes;
    row[1] = rz_last > 0.f ? rz_t / (rz_last + kTiny) : 0.f;
    row[2] = sqrtf(fabsf(rz_t));
    row[3] = sqrtf(rn);
    row[4] = sqrtf(xn);
    float* carry = stats + static_cast<long long>(chunk) * kStatsLanes;
    carry[0] = rz_t;
    carry[1] = rz_last;
  }
}

}  // namespace tpuamg

// rz_parts[0 .. parts_for(n)) = per-block partials of r.z.
extern "C" int tpuamg_pcg_rz(const void* r, const void* z, void* rz_parts,
                             long long n, void* stream) {
  using namespace tpuamg;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pcg_rz_kernel<<<parts_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(z),
      static_cast<float*>(rz_parts), n);
  return static_cast<int>(cudaGetLastError());
}

// p_new = z + beta p_old, q = Q p_new, pq_parts = partials of p_new.q;
// Q: nd float32 planes (nd, n).  Reads rzbuf[it], writes rzbuf[it + 1]
// and (it > 0) stats row it-1 from the previous pcg_xr's norm_parts.
// p_new must not alias p_old.
extern "C" int tpuamg_pcg_pq(const void* Q, int nd, const int* offsets,
                             const void* z, const void* p_old, void* p_new,
                             void* q, long long n, const void* rz_parts,
                             void* pq_parts, const void* norm_parts,
                             void* rzbuf, int it, void* stats,
                             void* stream) {
  using namespace tpuamg;
  if (nd < 0 || nd > kMaxDiags || n <= 0 || it < 0 || p_new == p_old)
    return static_cast<int>(cudaErrorInvalidValue);
  pcg_pq_kernel<<<parts_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q), static_cast<const float*>(z),
      static_cast<const float*>(p_old), static_cast<float*>(p_new),
      static_cast<float*>(q), n, make_offsets(nd, offsets),
      static_cast<const float*>(rz_parts), static_cast<float*>(pq_parts),
      static_cast<const float*>(norm_parts), static_cast<float*>(rzbuf), it,
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// alpha = rzbuf[it + 1] / (p.q + tiny); x += alpha p; r -= alpha q;
// norm_parts = partials of |r|^2 (first kMaxParts) and |x|^2 (next);
// stats[it, 0] = alpha.
extern "C" int tpuamg_pcg_xr(void* x, void* r, const void* p, const void* q,
                             long long n, const void* pq_parts,
                             const void* rzbuf, int it, void* norm_parts,
                             void* stats, void* stream) {
  using namespace tpuamg;
  if (n <= 0 || it < 0) return static_cast<int>(cudaErrorInvalidValue);
  pcg_xr_kernel<<<parts_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(r),
      static_cast<const float*>(p), static_cast<const float*>(q), n,
      static_cast<const float*>(pq_parts), static_cast<const float*>(rzbuf),
      it, static_cast<float*>(norm_parts), static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// Close the chunk: stats row chunk-1 (beta, sqrt|rz_T|, norms) and row
// chunk = (rz_T, rz_last), rz_T from the last pcg_rz's partials.
extern "C" int tpuamg_pcg_finish(const void* rz_parts, const void* norm_parts,
                                 long long n, const void* rzbuf, int chunk,
                                 void* stats, void* stream) {
  using namespace tpuamg;
  if (n <= 0 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  pcg_finish_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rz_parts),
      static_cast<const float*>(norm_parts), parts_for(n),
      static_cast<const float*>(rzbuf), chunk, static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}
