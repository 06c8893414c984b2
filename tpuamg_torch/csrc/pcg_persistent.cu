// K5: a whole chunk of the fused PCG, the multigrid cycle included, as ONE
// persistent cooperative launch.
//
// Replaces tpuamg/amg/grid_fused.py:_pcg_kernel (with the cycle of
// :_cycle_machine inside it), which runs `chunk` PCG iterations -- dot
// products, the outer SpMV, the vector updates and one whole V/W cycle
// each -- as one sequential program on one TPU core.  The earlier port of
// it (pcg.cu around vcycle.cu's pieces, amg/grid_fused.py::
// pcg_chunk_sequenced) issues 3 + ~1,000 launches per W-cycle iteration
// from the host, and the card idles ~90% of the chunk between them.
//
// Design for Hopper: every block of a grid sized to be co-resident
// (SMs x occupancy, cudaLaunchCooperativeKernel) loops over the chunk's
// iterations inside the kernel; between dependent steps the grid meets
// at cooperative_groups' grid.sync().  The cycle is the op program of
// amg/cycle_program.py, run by the device interpreter that this kernel
// shares with K2's one-launch cycle (csrc/cycle_program.cuh: the table
// layouts, the fused ops and their traps), with r as level 0's
// right-hand side.
//
// The chunk stops at the crossing: the host passes the solve's stop test
// (type and threshold, pcg_fused's), and after the barrier that completes
// an iteration's r.z every block evaluates it on the same reduced values,
// so all blocks leave the loop together; a non-finite sqrt|r.z| also ends
// the chunk.  Block 0 writes the iterations run and the reason into the
// carry row.  Type 0 runs the whole chunk (the JAX package's semantics).
//
// The PCG body keeps pcg.cu's arithmetic: rz = r.z; beta = rz / rz_prev
// (0 while rz_prev <= 0); p_new = z + beta p_old with q = Q p_new
// recomputed at the neighbouring offsets (p double-buffered: blocks read
// p_old across block edges); alpha = rz / (p.q + tiny); x += alpha p,
// r -= alpha q; the norms; then z = M r by the cycle program, r its
// right-hand side.  After the last iteration one more r.z closes the
// stats rows, whose layout is pcg.cu's: row it = (alpha, beta, sqrt|rz|,
// |r|, |x|) with row it's beta and sqrt|rz| those of the next r.z, and
// row chunk = (rz_T, rz_last, iterations run, why: 0 none, 1 crossed,
// 2 non-finite).  The scalars stay in registers: every
// block re-reduces the per-block partials in one fixed order, so all
// blocks hold the same bits (no float atomics).  The bits depend on the
// grid size, and are the same from run to run on one grid.
//
// Bound on an H100: bytes (inputs once: Q, the cycle's planes and T, and
// x, r, p, z; chunk_work in chip_smoke.py), but the algorithm streams far
// more (every level's planes at every visit), and at these sizes what
// the chunk costs is ~2-4 us per op: one grid barrier and a few rounds of
// memory latency, 568 ops per W-cycle iteration at n=256.  So the ops
// that would run long on few threads are spread out: a restriction gives
// each fine child its own lane, the coarse GEMV splits its columns
// (CycleProgram.nsplit).
//
// Traps (and those of the interpreter, csrc/cycle_program.cuh):
//  - r, p, q, x, z and the partials are written inside this launch, so
//    they are read with plain loads; only Q takes the read-only path;
//  - the launch is cooperative: a grid larger than can be co-resident
//    fails (cudaErrorCooperativeLaunchTooLarge) and the wrapper raises;
//    there is no fallback to the sequenced chunk.
#include <cstring>

#include "cycle_program.cuh"

namespace tpuamg_pcgp {

using namespace tpuamg_cycle;

constexpr int kStatsLanes = 128;     // = grid_fused.STATS_LANES
constexpr float kTiny = 1e-30f;

// the host argument vector (amg/grid_fused.py::_PERSISTENT_ARGS)
enum ArgWord {
  aLevels = 0, aNLevels, aOps, aNOps, aQPlanes, aX, aR, aP0, aP1, aQ, aZ,
  aN, aParts, aRzPrev, aStats, aChunk, aT, aBc, aXc, aPartial, aRowsC, aNc,
  aNSplit, aStop, aThr, aTol, kNArgs
};

// the stop test (amg/grid_fused.py::_stop_args): 0 = none (whole chunk),
// 1 = ||r|| <= thr, 2 = sqrt|r.z| <= thr, 3 = ||r|| <= tol max(||x||, tiny)
constexpr double kTinyStop = 1e-300;

struct Offs {
  int nd;
  int o[kMaxDiags];
};

struct Args {
  const long long* levels;
  const int* ops;
  Cycle cy;            // b0 = r
  const float* Q;
  Offs qo;
  float* x;
  float* r;
  float* p0;
  float* p1;
  float* q;
  float* z;            // = level 0's x: the cycle writes z there
  long long n;
  float* parts;        // 4 x gridDim: rz, pq, |r|^2, |x|^2 partials
  const float* rz_prev;
  float* stats;
  int chunk;
  int stop;
  double thr;
  double tol;
};

// Sum over the block of v by a fixed tree; every thread gets the result.
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

// parts[0] + ... + parts[np - 1] in one fixed order, in every block.
// Plain loads: other blocks wrote the partials in this launch.
__device__ __forceinline__ float reduce_parts(const float* parts, int np,
                                              float* sh) {
  float v = 0.f;
  for (int i = threadIdx.x; i < np; i += kThreads) v += parts[i];
  return block_sum(v, sh);
}

// Block partial of v into parts[blockIdx.x], a grid barrier, and the
// grid total in every block.
__device__ __forceinline__ float grid_sum(float v, float* parts, float* sh,
                                          cg::grid_group& grid) {
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0) parts[blockIdx.x] = s;
  grid.sync();
  return reduce_parts(parts, gridDim.x, sh);
}

template <typename P>
__global__ void __launch_bounds__(kThreads) pcg_persistent_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[kThreads];
  // the level table, then the op table, in dynamic shared memory
  extern __shared__ long long tables[];
  const int* ops = stage_tables(a.levels, a.cy.nlevels, a.ops, a.cy.nops,
                                tables);
  const int nb = gridDim.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  const long long gstride = static_cast<long long>(nb) * kThreads;
  const long long n = a.n;
  float* rz_parts = a.parts;
  float* pq_parts = a.parts + nb;
  float* rn_parts = a.parts + 2 * nb;
  float* xn_parts = a.parts + 3 * nb;
  const bool lead = blockIdx.x == 0;
  const bool writer = lead && threadIdx.x == 0;
  if (lead)
    for (int i = threadIdx.x; i < (a.chunk + 1) * kStatsLanes; i += kThreads)
      a.stats[i] = 0.f;
  float rz_last = *a.rz_prev;
  // does the cycle start with an op on level 0 that reads r[i] only
  // in the thread that writes it (ZERO, or a cold step)?
  const int op0 = ops[0];
  const int kind0 = op0 & 0xff;
  const int flags0 = op0 >> 16;
  const bool own_start =
      ((op0 >> 8) & 0xff) == 0 &&
      (kind0 == kZero || (kind0 == kChebStep && (flags0 & fCold)));
  float* p_old = a.p0;
  float* p_new = a.p1;
  float* x = a.x;
  float* r = a.r;
  const float* z = a.z;

  // it counts the iterations run; the loop's last pass (it == chunk, or
  // the one that finds the crossing) only closes the stats rows
  int ran = a.chunk;
  int why = 0;          // 1 = met the stop test, 2 = non-finite residual
  float rz = 0.f;
  for (int it = 0;; ++it) {
    // rz = r.z
    float acc = 0.f;
    for (long long i = gtid; i < n; i += gstride) acc = fmaf(r[i], z[i], acc);
    rz = grid_sum(acc, rz_parts, sh, grid);
    const float beta = rz_last > 0.f ? rz / (rz_last + kTiny) : 0.f;
    if (it > 0) {
      const float res = sqrtf(fabsf(rz));
      if (writer) {
        float* row = a.stats + static_cast<long long>(it - 1) * kStatsLanes;
        row[1] = beta;
        row[2] = res;
      }
      // Iteration it - 1's stop test, in every block on the same values:
      // rz from the barrier just passed, ||r|| and ||x|| re-reduced from
      // partials that no block rewrites before the next barrier.  So
      // every block takes the same branch.
      if (a.stop != 0) {
        if (!isfinite(res)) {
          why = 2;
        } else if (a.stop == 2) {
          why = static_cast<double>(res) <= a.thr ? 1 : 0;
        } else {
          const double rt = sqrtf(reduce_parts(rn_parts, nb, sh));
          if (a.stop == 1) {
            why = rt <= a.thr ? 1 : 0;
          } else {
            const double xt = sqrtf(reduce_parts(xn_parts, nb, sh));
            why = rt <= a.tol * fmax(xt, kTinyStop) ? 1 : 0;
          }
        }
        if (why != 0) {
          ran = it;
          break;
        }
      }
    }
    if (it == a.chunk) break;
    // p_new = z + beta p_old; q = Q p_new (p_new at j recomputed from
    // p_old, which no block writes in this step); p_new.q
    acc = 0.f;
    for (long long i = gtid; i < n; i += gstride) {
      float qi = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < a.qo.nd; ++dd) {
        const long long j = i + a.qo.o[dd];
        const float pj =
            (j >= 0 && j < n) ? fmaf(beta, p_old[j], z[j]) : 0.f;
        qi = fmaf(ro(a.Q, static_cast<long long>(dd) * n + i), pj, qi);
      }
      const float pi = fmaf(beta, p_old[i], z[i]);
      p_new[i] = pi;
      a.q[i] = qi;
      acc = fmaf(pi, qi, acc);
    }
    const float pq = grid_sum(acc, pq_parts, sh, grid);
    const float alpha = rz / (pq + kTiny);
    // x += alpha p; r -= alpha q; |r|^2, |x|^2
    float rn = 0.f, xn = 0.f;
    for (long long i = gtid; i < n; i += gstride) {
      const float xi = fmaf(alpha, p_new[i], x[i]);
      const float ri = fmaf(-alpha, a.q[i], r[i]);
      x[i] = xi;
      r[i] = ri;
      rn = fmaf(ri, ri, rn);
      xn = fmaf(xi, xi, xn);
    }
    const float sr = block_sum(rn, sh);
    const float sx = block_sum(xn, sh);
    if (threadIdx.x == 0) {
      rn_parts[blockIdx.x] = sr;
      xn_parts[blockIdx.x] = sx;
    }
    // z = M r: the cycle program, r as level 0's right-hand side.  A
    // cycle that starts with a grid op on level 0 reads r[i] only in the
    // thread that wrote it here, so it needs no barrier first.
    if (!own_start) grid.sync();
    run_cycle<P>(a.cy, ops, tables, grid, gtid, gstride);
    // the cycle made at least one grid barrier since the partials
    if (lead) {
      const float rt = reduce_parts(rn_parts, nb, sh);
      const float xt = reduce_parts(xn_parts, nb, sh);
      if (threadIdx.x == 0) {
        float* row = a.stats + static_cast<long long>(it) * kStatsLanes;
        row[0] = alpha;
        row[3] = sqrtf(rt);
        row[4] = sqrtf(xt);
      }
    }
    float* tmp = p_old;
    p_old = p_new;
    p_new = tmp;
    rz_last = rz;
  }
  // p after `ran` iterations is p_old; the host takes p from the buffer
  // that a whole chunk ends in, so an early exit of the other parity
  // copies it there (no block reads p again in this launch)
  if ((a.chunk - ran) & 1)
    for (long long i = gtid; i < n; i += gstride) p_new[i] = p_old[i];
  if (writer) {
    float* carry = a.stats + static_cast<long long>(a.chunk) * kStatsLanes;
    carry[0] = rz;
    carry[1] = rz_last;
    carry[2] = static_cast<float>(ran);
    carry[3] = static_cast<float>(why);
  }
}

inline const void* select(int planes_bf16) {
  return planes_bf16
             ? (const void*)(&pcg_persistent_kernel<__nv_bfloat16>)
             : (const void*)(&pcg_persistent_kernel<float>);
}

}  // namespace tpuamg_pcgp

// The table layouts this library was built with, for the host to check
// against amg/cycle_program.py.
extern "C" int tpuamg_pcg_persistent_layout(int* out4) {
  using namespace tpuamg_pcgp;
  out4[0] = kLevelWords;
  out4[1] = kOpWords;
  out4[2] = kNArgs;
  out4[3] = kMaxDiags;
  return 0;
}

// out2 = (resident blocks per SM, SMs) for the kernel with `smem` bytes
// of staged tables, on the current device.
extern "C" int tpuamg_pcg_persistent_occupancy(int planes_bf16, int smem,
                                               int* out2) {
  using namespace tpuamg_pcgp;
  const void* k = select(planes_bf16);
  if (smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(k, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                      smem);
  out2[0] = per_sm;
  out2[1] = sms;
  cudaGetLastError();
  return static_cast<int>(e);
}

// One chunk: args is the kNArgs-long host vector of pointers and sizes
// (amg/grid_fused.py::_PERSISTENT_ARGS), q_offsets the outer operator's
// ndq offsets.  Launched cooperatively on `grid` blocks of kThreads
// threads with smem bytes of dynamic shared memory (the level and op
// tables); a grid that cannot be co-resident returns
// cudaErrorCooperativeLaunchTooLarge and nothing runs.
extern "C" int tpuamg_pcg_persistent(const long long* args, int nargs,
                                     const int* q_offsets, int ndq,
                                     int planes_bf16, int grid, int smem,
                                     void* stream) {
  using namespace tpuamg_pcgp;
  const void* k = select(planes_bf16);
  if (nargs != kNArgs || ndq < 0 || ndq > kMaxDiags ||
      grid < 1 || args[aChunk] < 1 || args[aN] < 1 || args[aNSplit] < 1 ||
      args[aNLevels] < 1 || args[aNLevels] > 255 ||
      args[aNOps] < 1 || args[aStop] < 0 || args[aStop] > 3 ||
      smem != table_bytes(args[aNLevels], args[aNOps]))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t se = allow_smem(k, smem);
  if (se != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(se);
  }
  Args a;
  a.levels = reinterpret_cast<const long long*>(args[aLevels]);
  a.cy.nlevels = static_cast<int>(args[aNLevels]);
  a.ops = reinterpret_cast<const int*>(args[aOps]);
  a.cy.nops = static_cast<int>(args[aNOps]);
  a.Q = reinterpret_cast<const float*>(args[aQPlanes]);
  a.qo.nd = ndq;
  for (int d = 0; d < kMaxDiags; ++d) a.qo.o[d] = d < ndq ? q_offsets[d] : 0;
  a.x = reinterpret_cast<float*>(args[aX]);
  a.r = reinterpret_cast<float*>(args[aR]);
  a.cy.b0 = a.r;
  a.p0 = reinterpret_cast<float*>(args[aP0]);
  a.p1 = reinterpret_cast<float*>(args[aP1]);
  a.q = reinterpret_cast<float*>(args[aQ]);
  a.z = reinterpret_cast<float*>(args[aZ]);
  a.n = args[aN];
  a.parts = reinterpret_cast<float*>(args[aParts]);
  a.rz_prev = reinterpret_cast<const float*>(args[aRzPrev]);
  a.stats = reinterpret_cast<float*>(args[aStats]);
  a.chunk = static_cast<int>(args[aChunk]);
  a.stop = static_cast<int>(args[aStop]);
  double dv[2];
  memcpy(dv, &args[aThr], sizeof(dv));   // aThr, aTol: doubles' bits
  a.thr = dv[0];
  a.tol = dv[1];
  a.cy.T = reinterpret_cast<const void*>(args[aT]);
  a.cy.bc = reinterpret_cast<float*>(args[aBc]);
  a.cy.xc = reinterpret_cast<float*>(args[aXc]);
  a.cy.partial = reinterpret_cast<float*>(args[aPartial]);
  a.cy.rows_c = static_cast<int>(args[aRowsC]);
  a.cy.nc = static_cast<int>(args[aNc]);
  a.cy.nsplit = static_cast<int>(args[aNSplit]);
  void* kargs[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      k, dim3(grid), dim3(kThreads), kargs, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();   // clears a launch error
  return static_cast<int>(e != cudaSuccess ? e : last);
}
