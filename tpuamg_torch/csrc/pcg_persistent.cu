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
// amg/cycle_program.py: an int32 op table and an int64 level table
// (pointers, sizes, offsets), copied into each block's shared memory at
// the start, so that no op waits on a global load to learn what to do.
// Every op runs on all blocks in grid-stride loops and ends at a grid
// barrier, the small levels' too: one block walking a small level alone
// costs more rounds of memory latency than the barriers it saves (on the
// H100, every such threshold tried made the chunk slower).  Where the
// next op reads only what the same thread wrote, the op carries no
// barrier.  One block of kThreads = 512 threads per SM: 1024 threads, or
// more resident blocks, were slower.
//
// Fewer barriers: one Chebyshev step is one op (CHEB_STEP).  C is the
// nodal block inverse, so the C-apply of row i reads t only inside its
// node block of F rows, which one warp holds: t stays in registers and
// crosses lanes by __shfl_sync.  The pass reads x at A's neighbouring
// offsets while it writes x + d, so each level has two x buffers and the
// op names the one it reads (src) and the one it writes (dst).  The
// residual before a restriction is computed inside the restriction
// (RESID_RESTRICT), which reads every fine entry once.  A visit is 8 ops
// where the host-sequenced cycle makes 16 launches.
//
// The PCG body keeps pcg.cu's arithmetic: rz = r.z; beta = rz / rz_prev
// (0 while rz_prev <= 0); p_new = z + beta p_old with q = Q p_new
// recomputed at the neighbouring offsets (p double-buffered: blocks read
// p_old across block edges); alpha = rz / (p.q + tiny); x += alpha p,
// r -= alpha q; the norms; then z = M r by the cycle program, r its
// right-hand side.  After the last iteration one more r.z closes the
// stats rows, whose layout is pcg.cu's: row it = (alpha, beta, sqrt|rz|,
// |r|, |x|) with row it's beta and sqrt|rz| those of the next r.z, and
// row chunk = (rz_T, rz_last).  The scalars stay in registers: every
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
// each fine child its own lane, the coarse GEMV splits into columns of
// at most 16.
//
// Traps, each named where it bites:
//  - every vector here (x, t, d, b, bc, xc, r, z, p, q, the partials) is
//    written inside this launch, so it is read with plain loads, never
//    __ldg or `const __restrict__` (ld.global.nc does not see other
//    blocks' writes); only planes, the mask, T and Q take the read-only
//    path (`ro`);
//  - every block makes the same grid.sync() calls in the same order: the
//    barrier is a flag of the op record, and no branch on the block or on
//    i >= n returns early;
//  - the launch is cooperative: a grid larger than can be co-resident
//    fails (cudaErrorCooperativeLaunchTooLarge) and the wrapper raises;
//    there is no fallback to the sequenced chunk.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace tpuamg_pcgp {

constexpr int kMaxDiags = 64;        // = kernels.MAX_DIAGS
constexpr int kLanes = 128;
constexpr int kStatsLanes = 128;     // = grid_fused.STATS_LANES
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 512;        // per block, one block per SM

// amg/cycle_program.py: op records and level words
enum OpKind {
  kZero = 0, kChebStep, kResidRestrict, kProlong, kCoarseGemv, kCoarseReduce
};
// an op is kind | level << 8 | flags << 16, s bits, c bits, 0
constexpr int kOpWords = 4;
enum OpFlag { fFirst = 1, fCold = 2, fSrc = 4, fDst = 8, fNSrc = 16,
              fNoBarrier = 32 };
enum LevelWord {
  kA = 0, kC, kM, kX0, kX1, kD, kB, kNextB, kNextX0, kNextX1, kN, kNNext,
  kK, kKc, kF, kNLead, kLead, kNdA = kLead + 3, kNdC, kOffA,
  kOffC = kOffA + kMaxDiags, kLevelWords = kOffC + kMaxDiags
};
// the host argument vector (amg/grid_fused.py::_PERSISTENT_ARGS)
enum ArgWord {
  aLevels = 0, aNLevels, aOps, aNOps, aQPlanes, aX, aR, aP0, aP1, aQ, aZ,
  aN, aParts, aRzPrev, aStats, aChunk, aT, aBc, aXc, aPartial, aRowsC, aNc,
  aNSplit, kNArgs
};

struct Offs {
  int nd;
  int o[kMaxDiags];
};

struct Args {
  const long long* levels;
  int nlevels;
  const int* ops;
  int nops;
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
  const void* T;
  float* bc;
  float* xc;
  float* partial;
  int rows_c, nc, nsplit;
};

// The read-only path, for what no block writes during the launch.
__device__ __forceinline__ float ro(const float* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ro(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p) + i)));
}

// C diagonals whose loads are issued before the t-pass (2F - 1 = 3 for
// the bidomain's F = 2); further ones load in the C loop
constexpr int kCHoist = 3;

template <typename T>
__device__ __forceinline__ T* ptr(long long w) {
  return reinterpret_cast<T*>(w);
}

// sum_d planes[d, i] * x[i + off[d]] (0 outside [0, n)), float32 FMAs in
// diagonal order as dia_sweep.cuh's dia_row; x by plain loads: it was
// written in this launch.
template <typename P>
__device__ __forceinline__ float dia_row(const P* planes, const float* x,
                                         long long n, long long i,
                                         const long long* offs, int nd) {
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < nd; ++d) {
    const long long j = i + offs[d];
    const float xv = (j >= 0 && j < n) ? x[j] : 0.f;
    acc = fmaf(ro(planes, static_cast<long long>(d) * n + i), xv, acc);
  }
  return acc;
}

// One op of the cycle program over items start, start + stride, ... (grid
// stride: a warp holds 32 consecutive items, and n is a multiple of 128,
// so a warp enters and leaves every loop together).  L is the op's level
// row in shared memory.
template <typename P>
__device__ __forceinline__ void run_op(const Args& a, int w0,
                                       const int* op, const long long* L,
                                       long long start, long long stride) {
  const int kind = w0 & 0xff;
  const int flags = w0 >> 16;
  if (kind == kCoarseGemv) {
    // partial[s, R*128 + l] = sum_{m in split s} T[R, m, l] bc[m], as
    // vcycle.cu's coarse_gemv_kernel (thread (R, s, l)), over the
    // program's own splits of at most 16 columns
    const P* T = static_cast<const P*>(a.T);
    const int chunk = (a.nc + a.nsplit - 1) / a.nsplit;
    const long long items =
        static_cast<long long>(a.rows_c) * a.nsplit * kLanes;
    for (long long w = start; w < items; w += stride) {
      const int l = static_cast<int>(w % kLanes);
      const long long rs = w / kLanes;
      const int s = static_cast<int>(rs % a.nsplit);
      const int R = static_cast<int>(rs / a.nsplit);
      const int m0 = s * chunk;
      const int m1 = min(a.nc, m0 + chunk);
      const long long col = static_cast<long long>(R) * a.nc * kLanes + l;
      // loads in groups of 8, issued before their FMAs: a split is a few
      // rounds of memory latency
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int m = m0;
      for (; m + 7 < m1; m += 8) {
        float tv[8], bv[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          tv[k] = ro(T, col + static_cast<long long>(m + k) * kLanes);
          bv[k] = a.bc[m + k];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[k & 3] = fmaf(tv[k], bv[k], acc[k & 3]);
      }
      for (; m < m1; ++m)
        acc[0] = fmaf(ro(T, col + static_cast<long long>(m) * kLanes),
                      a.bc[m], acc[0]);
      a.partial[static_cast<long long>(s) * a.nc + R * kLanes + l] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    return;
  }
  if (kind == kCoarseReduce) {
    // the splits in order, their loads in groups of 8
    for (long long i = start; i < a.nc; i += stride) {
      float acc = 0.f;
      int s = 0;
      for (; s + 7 < a.nsplit; s += 8) {
        float pv[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          pv[k] = a.partial[static_cast<long long>(s + k) * a.nc + i];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += pv[k];
      }
      for (; s < a.nsplit; ++s)
        acc += a.partial[static_cast<long long>(s) * a.nc + i];
      a.xc[i] = acc;
    }
    return;
  }
  const int lv = (w0 >> 8) & 0xff;
  const long long n = L[kN];
  float* xs = ptr<float>(L[(flags & fSrc) ? kX1 : kX0]);
  const float* b = lv == 0 ? a.r : ptr<const float>(L[kB]);
  switch (kind) {
    case kZero: {
      float* x = ptr<float>(L[(flags & fDst) ? kX1 : kX0]);
      for (long long i = start; i < n; i += stride) x[i] = 0.f;
      break;
    }
    case kChebStep: {
      // t = b - A x_src (b when cold); C t inside the node block by warp
      // shuffles; d = s C t (first) or s d + c C t; x_dst = x_src + d
      const P* A = ptr<const P>(L[kA]);
      const P* C = ptr<const P>(L[kC]);
      float* d = ptr<float>(L[kD]);
      float* xd = ptr<float>(L[(flags & fDst) ? kX1 : kX0]);
      const int ndA = static_cast<int>(L[kNdA]);
      const int ndC = static_cast<int>(L[kNdC]);
      const int F = static_cast<int>(L[kF]);
      const bool cold = flags & fCold;
      const bool first = flags & fFirst;
      const float s = __int_as_float(op[1]);
      const float c = __int_as_float(op[2]);
      const int lane = threadIdx.x & 31;
      for (long long i = start; i < n; i += stride) {
        // every load that does not wait on t goes out first: the small
        // levels are latency, not bandwidth
        const int f = static_cast<int>(i % F);
        const float bi = b[i];
        const float di = first ? 0.f : d[i];
        const float xi = cold ? 0.f : xs[i];
        float cv[kCHoist];
#pragma unroll
        for (int k = 0; k < kCHoist; ++k) {
          const int o = k < ndC ? static_cast<int>(L[kOffC + k]) : F;
          cv[k] = (f + o >= 0 && f + o < F)
                      ? ro(C, static_cast<long long>(k) * n + i) : 0.f;
        }
        const float t =
            cold ? bi : bi - dia_row(A, xs, n, i, L + kOffA, ndA);
        float ct = 0.f;
        for (int dd = 0; dd < ndC; ++dd) {
          const int o = static_cast<int>(L[kOffC + dd]);
          const float tj = __shfl_sync(0xffffffffu, t, (lane + o) & 31);
          // C is zero across node blocks, whose rows no other warp holds
          if (f + o >= 0 && f + o < F) {
            float cd = 0.f;
#pragma unroll
            for (int k = 0; k < kCHoist; ++k)
              if (k == dd) cd = cv[k];
            if (dd >= kCHoist) cd = ro(C, static_cast<long long>(dd) * n + i);
            ct = fmaf(cd, tj, ct);
          }
        }
        const float dn = first ? s * ct : s * di + c * ct;
        d[i] = dn;
        xd[i] = xi + dn;
      }
      break;
    }
    case kResidRestrict: {
      // pair sums of (b - A x) over every leading axis and over x-node
      // pairs of one field, in vcycle.cu's restrict_kernel order.  Coarse
      // entry ic takes G = 2^(nlead+1) consecutive lanes, one fine child
      // each (child k = 2 e + ex); the group's first lane sums the G
      // residuals in k order by warp shuffles (G divides 32, and G * nout
      // is a multiple of 32: a warp enters and leaves together).
      const P* A = ptr<const P>(L[kA]);
      const int ndA = static_cast<int>(L[kNdA]);
      float* bc = ptr<float>(L[kNextB]);
      const long long nout = L[kNNext];
      const int K = static_cast<int>(L[kK]);
      const int Kc = static_cast<int>(L[kKc]);
      const int F = static_cast<int>(L[kF]);
      const int nlead = static_cast<int>(L[kNLead]);
      const int row_c = Kc * kLanes;
      const int row_f = K * kLanes;
      const int G = 2 << nlead;
      const int lane = threadIdx.x & 31;
      for (long long w = start; w < nout * G; w += stride) {
        const long long ic = w / G;
        const int k = static_cast<int>(w % G);
        const long long clex = ic / row_c;
        const int Lc = static_cast<int>(ic % row_c);
        const int f = Lc % F;
        const int cx = Lc / F;
        const int e = k >> 1;
        long long rem = clex, flex = 0, mult = 1;
        for (int ax = nlead - 1; ax >= 0; --ax) {
          const long long cd = L[kLead + ax];
          flex += (2 * (rem % cd) + ((e >> ax) & 1)) * mult;
          rem /= cd;
          mult *= 2 * cd;
        }
        const int lf = (2 * cx + (k & 1)) * F + f;
        float r = 0.f;
        if (lf < row_f) {
          const long long fi = flex * row_f + lf;
          r = b[fi] - dia_row(A, xs, n, fi, L + kOffA, ndA);
        }
        float acc = 0.f;
        const int base = lane & ~(G - 1);
        for (int kk = 0; kk < G; ++kk)
          acc += __shfl_sync(0xffffffffu, r, base + kk);
        if (k == 0) bc[ic] = acc;
      }
      break;
    }
    case kProlong: {
      // x_src += mask * (coarse correction duplicated), vcycle.cu's
      // prolong_kernel; the coarse x is buffer nsrc of level lv + 1
      const P* mask = ptr<const P>(L[kM]);
      const float* xc = ptr<const float>(L[(flags & fNSrc) ? kNextX1
                                                           : kNextX0]);
      const int K = static_cast<int>(L[kK]);
      const int Kc = static_cast<int>(L[kKc]);
      const int F = static_cast<int>(L[kF]);
      const int nlead = static_cast<int>(L[kNLead]);
      const int row_f = K * kLanes;
      for (long long i = start; i < n; i += stride) {
        const long long flex = i / row_f;
        const int lf = static_cast<int>(i % row_f);
        const int Lc = (lf / F / 2) * F + lf % F;
        long long rem = flex, clex = 0, mult = 1;
        for (int ax = nlead - 1; ax >= 0; --ax) {
          const long long cd = L[kLead + ax];
          const long long fc = rem % (2 * cd);
          rem /= 2 * cd;
          clex += (fc / 2) * mult;
          mult *= cd;
        }
        xs[i] += ro(mask, i) * xc[clex * Kc * kLanes + Lc];
      }
      break;
    }
    default:
      break;
  }
}

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
__device__ __forceinline__ void run_cycle(const Args& a, const int* ops,
                                          const long long* levels,
                                          cg::grid_group& grid,
                                          long long gtid, long long gstride) {
  for (int k = 0; k < a.nops; ++k) {
    const int* op = ops + k * kOpWords;
    const int w0 = op[0];
    const int lv = (w0 >> 8) & 0xff;
    run_op<P>(a, w0, op,
              levels + static_cast<long long>(lv < a.nlevels ? lv : 0) *
                           kLevelWords,
              gtid, gstride);
    // the barrier is data every block reads alike: all blocks make the
    // same grid.sync() calls (a block that skipped one would hang the
    // card).  No barrier: the next op reads only what the same thread
    // wrote (cycle_program.compile_ops says when).
    if (!((w0 >> 16) & fNoBarrier)) grid.sync();
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads) pcg_persistent_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[kThreads];
  // the level table, then the op table, in dynamic shared memory
  extern __shared__ long long tables[];
  const int level_words = a.nlevels * kLevelWords;
  for (int i = threadIdx.x; i < level_words; i += kThreads)
    tables[i] = a.levels[i];
  int* ops = reinterpret_cast<int*>(tables + level_words);
  for (int i = threadIdx.x; i < a.nops * kOpWords; i += kThreads)
    ops[i] = a.ops[i];
  __syncthreads();
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

  for (int it = 0; it < a.chunk; ++it) {
    // rz = r.z
    float acc = 0.f;
    for (long long i = gtid; i < n; i += gstride) acc = fmaf(r[i], z[i], acc);
    const float rz = grid_sum(acc, rz_parts, sh, grid);
    const float beta = rz_last > 0.f ? rz / (rz_last + kTiny) : 0.f;
    if (writer && it > 0) {
      float* row = a.stats + static_cast<long long>(it - 1) * kStatsLanes;
      row[1] = beta;
      row[2] = sqrtf(fabsf(rz));
    }
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
    run_cycle<P>(a, ops, tables, grid, gtid, gstride);
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
  float acc = 0.f;
  for (long long i = gtid; i < n; i += gstride) acc = fmaf(r[i], z[i], acc);
  const float rz_t = grid_sum(acc, rz_parts, sh, grid);
  if (writer) {
    float* row = a.stats + static_cast<long long>(a.chunk - 1) * kStatsLanes;
    row[1] = rz_last > 0.f ? rz_t / (rz_last + kTiny) : 0.f;
    row[2] = sqrtf(fabsf(rz_t));
    float* carry = a.stats + static_cast<long long>(a.chunk) * kStatsLanes;
    carry[0] = rz_t;
    carry[1] = rz_last;
  }
}

inline const void* select(int planes_bf16) {
  return planes_bf16
             ? (const void*)(&pcg_persistent_kernel<__nv_bfloat16>)
             : (const void*)(&pcg_persistent_kernel<float>);
}

// Allow `smem` bytes of dynamic shared memory (the staged tables).
inline cudaError_t allow_smem(const void* k, int smem) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
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
      smem != static_cast<int>(args[aNLevels] * kLevelWords * 8 +
                               args[aNOps] * kOpWords * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t se = allow_smem(k, smem);
  if (se != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(se);
  }
  Args a;
  a.levels = reinterpret_cast<const long long*>(args[aLevels]);
  a.nlevels = static_cast<int>(args[aNLevels]);
  a.ops = reinterpret_cast<const int*>(args[aOps]);
  a.nops = static_cast<int>(args[aNOps]);
  a.Q = reinterpret_cast<const float*>(args[aQPlanes]);
  a.qo.nd = ndq;
  for (int d = 0; d < kMaxDiags; ++d) a.qo.o[d] = d < ndq ? q_offsets[d] : 0;
  a.x = reinterpret_cast<float*>(args[aX]);
  a.r = reinterpret_cast<float*>(args[aR]);
  a.p0 = reinterpret_cast<float*>(args[aP0]);
  a.p1 = reinterpret_cast<float*>(args[aP1]);
  a.q = reinterpret_cast<float*>(args[aQ]);
  a.z = reinterpret_cast<float*>(args[aZ]);
  a.n = args[aN];
  a.parts = reinterpret_cast<float*>(args[aParts]);
  a.rz_prev = reinterpret_cast<const float*>(args[aRzPrev]);
  a.stats = reinterpret_cast<float*>(args[aStats]);
  a.chunk = static_cast<int>(args[aChunk]);
  a.T = reinterpret_cast<const void*>(args[aT]);
  a.bc = reinterpret_cast<float*>(args[aBc]);
  a.xc = reinterpret_cast<float*>(args[aXc]);
  a.partial = reinterpret_cast<float*>(args[aPartial]);
  a.rows_c = static_cast<int>(args[aRowsC]);
  a.nc = static_cast<int>(args[aNc]);
  a.nsplit = static_cast<int>(args[aNSplit]);
  void* kargs[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      k, dim3(grid), dim3(kThreads), kargs, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();   // clears a launch error
  return static_cast<int>(e != cudaSuccess ? e : last);
}
