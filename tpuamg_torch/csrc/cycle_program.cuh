// The device interpreter of the cycle op program (amg/cycle_program.py),
// shared by the three persistent cooperative kernels that run it:
//  - K5, csrc/pcg_persistent.cu: a chunk of PCG iterations, one whole
//    cycle inside each, level 0's right-hand side the PCG residual r;
//  - K2, csrc/cycle_persistent.cu: one whole cycle per launch, level 0's
//    right-hand side the caller's pre-masked b;
//  - K3, csrc/cheb_persistent.cu: one Chebyshev smoother sweep per
//    launch on one level of the unfused hierarchy, through the sweep
//    form of the interpreter (run_op<P, true>): any level length, and
//    two ops that only a sweep program holds (RESIDUAL, CHEB_APPLY).
//
// The program is an int32 op table and an int64 level table (pointers,
// sizes, offsets), copied into each block's shared memory when the kernel
// starts (stage_tables), so that no op waits on a global load to learn
// what to do.  Every op runs on all blocks in grid-stride loops and ends
// at a cooperative_groups grid.sync(), the small levels' too: one block
// walking a small level alone costs more rounds of memory latency than
// the barriers it saves (on the H100, every such threshold tried made
// the K5 chunk slower).  Where the next op reads only what the same
// thread wrote, the op carries no barrier (a flag of its record).  One
// block of kThreads = 512 threads per SM: 1024 threads, or more resident
// blocks, were slower.
//
// Fewer barriers: one Chebyshev step is one op (CHEB_STEP).  C is the
// nodal block inverse, so the C-apply of row i reads t only inside its
// node block of F rows, which one warp holds: t stays in registers and
// crosses lanes by __shfl_sync.  The pass reads x at A's neighbouring
// offsets while it writes x + d, so each level has two x buffers and the
// op names the one it reads (src) and the one it writes (dst).  The
// residual before a restriction is computed inside the restriction
// (RESID_RESTRICT), which reads every fine entry once: K1's residual
// form lives on inside these two ops.  A visit is 8 ops where the
// host-sequenced cycle (vcycle.cu's pieces + K1) makes 16 launches.
//
// Traps, each named where it bites:
//  - every vector here (x, t, d, b, bc, xc, the partials) is written
//    inside the launch, so it is read with plain loads, never __ldg or
//    `const __restrict__` (ld.global.nc does not see other blocks'
//    writes); only planes, the mask and T take the read-only path (`ro`);
//  - every block makes the same grid.sync() calls in the same order: the
//    barrier is a flag of the op record, and no branch on the block or on
//    i >= n returns early.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpuamg_cycle {

namespace cg = cooperative_groups;

constexpr int kMaxDiags = 64;        // = kernels.MAX_DIAGS
constexpr int kLanes = 128;
constexpr int kThreads = 512;        // per block, one block per SM

// amg/cycle_program.py: op records and level words
enum OpKind {
  kZero = 0, kChebStep, kResidRestrict, kProlong, kCoarseGemv, kCoarseReduce,
  kResidual, kChebApply
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

// What the ops read beyond the two tables.
struct Cycle {
  int nlevels;
  int nops;
  const float* b0;     // level 0's right-hand side (K5: r; K2: b)
  const void* T;       // (rows_c, nc, 128) coarse inverse, P
  float* bc;
  float* xc;
  float* partial;      // nsplit x nc per-split partial sums
  int rows_c, nc, nsplit;
};

// The bytes of dynamic shared memory the two staged tables take.
inline long long table_bytes(long long nlevels, long long nops) {
  return nlevels * kLevelWords * 8 + nops * kOpWords * 4;
}

// Allow `smem` bytes of dynamic shared memory (the staged tables).
inline cudaError_t allow_smem(const void* k, int smem) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

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

// Copy the level table, then the op table, into `tables` (dynamic shared
// memory); returns the op table there.
__device__ __forceinline__ const int* stage_tables(const long long* levels,
                                                   int nlevels,
                                                   const int* ops, int nops,
                                                   long long* tables) {
  const int level_words = nlevels * kLevelWords;
  for (int i = threadIdx.x; i < level_words; i += kThreads)
    tables[i] = levels[i];
  int* sops = reinterpret_cast<int*>(tables + level_words);
  for (int i = threadIdx.x; i < nops * kOpWords; i += kThreads)
    sops[i] = ops[i];
  __syncthreads();
  return sops;
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
// row in shared memory.  Sweep: a smoother sweep's program (K3), whose
// level length is any multiple of F: CHEB_STEP runs a warp while its
// first row is below n, its lanes past n idle in the shuffles, and the
// RESIDUAL and CHEB_APPLY ops exist.  K5 and K2 compile Sweep = false.
template <typename P, bool Sweep = false>
__device__ __forceinline__ void run_op(const Cycle& a, int w0,
                                       const int* op, const long long* L,
                                       long long start, long long stride) {
  const int kind = w0 & 0xff;
  const int flags = w0 >> 16;
  if (kind == kCoarseGemv) {
    // partial[s, R*128 + l] = sum_{m in split s} T[R, m, l] bc[m], as
    // vcycle.cu's coarse_gemv_kernel (thread (R, s, l)), over the
    // program's own column splits (CycleProgram.nsplit)
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
  const float* b = lv == 0 ? a.b0 : ptr<const float>(L[kB]);
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
      // a warp's first row is i - lane (Sweep: n need not be a multiple
      // of 32, and every lane of a warp takes part in its shuffles)
      for (long long i = start; (Sweep ? i - lane : i) < n; i += stride) {
        const bool in = !Sweep || i < n;
        // every load that does not wait on t goes out first: the small
        // levels are latency, not bandwidth
        const int f = static_cast<int>(i % F);
        const float bi = in ? b[i] : 0.f;
        const float di = (first || !in) ? 0.f : d[i];
        const float xi = (cold || !in) ? 0.f : xs[i];
        float cv[kCHoist];
#pragma unroll
        for (int k = 0; k < kCHoist; ++k) {
          const int o = k < ndC ? static_cast<int>(L[kOffC + k]) : F;
          cv[k] = (in && f + o >= 0 && f + o < F)
                      ? ro(C, static_cast<long long>(k) * n + i) : 0.f;
        }
        const float t = !in ? 0.f
                        : cold ? bi : bi - dia_row(A, xs, n, i, L + kOffA, ndA);
        float ct = 0.f;
        for (int dd = 0; dd < ndC; ++dd) {
          const int o = static_cast<int>(L[kOffC + dd]);
          const float tj = __shfl_sync(0xffffffffu, t, (lane + o) & 31);
          // C is zero across node blocks, whose rows no other warp holds
          if (in && f + o >= 0 && f + o < F) {
            float cd = 0.f;
#pragma unroll
            for (int k = 0; k < kCHoist; ++k)
              if (k == dd) cd = cv[k];
            if (dd >= kCHoist) cd = ro(C, static_cast<long long>(dd) * n + i);
            ct = fmaf(cd, tj, ct);
          }
        }
        if (in) {
          const float dn = first ? s * ct : s * di + c * ct;
          d[i] = dn;
          xd[i] = xi + dn;
        }
      }
      break;
    }
    case kResidual: {
      // r = b - A x_src, written where the level's next-b word points (a
      // sweep binds it to the returned r, or to its own t)
      if constexpr (Sweep) {
        const P* A = ptr<const P>(L[kA]);
        const int ndA = static_cast<int>(L[kNdA]);
        float* r = ptr<float>(L[kNextB]);
        for (long long i = start; i < n; i += stride)
          r[i] = b[i] - dia_row(A, xs, n, i, L + kOffA, ndA);
      }
      break;
    }
    case kChebApply: {
      // the C-apply of a step split in two ops (an F that does not divide
      // 32): t from the RESIDUAL before it, read at C's offsets;
      // d = s C t (first) or s d + c C t; x_dst = x_src + d
      if constexpr (Sweep) {
        const P* C = ptr<const P>(L[kC]);
        const int ndC = static_cast<int>(L[kNdC]);
        const float* t = ptr<const float>(L[kNextB]);
        float* d = ptr<float>(L[kD]);
        float* xd = ptr<float>(L[(flags & fDst) ? kX1 : kX0]);
        const bool first = flags & fFirst;
        const float s = __int_as_float(op[1]);
        const float c = __int_as_float(op[2]);
        for (long long i = start; i < n; i += stride) {
          const float ct = dia_row(C, t, n, i, L + kOffC, ndC);
          const float dn = first ? s * ct : s * d[i] + c * ct;
          d[i] = dn;
          xd[i] = xs[i] + dn;
        }
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

// The whole cycle: every op of the staged table in order, each followed
// by a grid barrier unless its record says otherwise.
template <typename P, bool Sweep = false>
__device__ __forceinline__ void run_cycle(const Cycle& a, const int* ops,
                                          const long long* levels,
                                          cg::grid_group& grid,
                                          long long gtid, long long gstride) {
  for (int k = 0; k < a.nops; ++k) {
    const int* op = ops + k * kOpWords;
    const int w0 = op[0];
    const int lv = (w0 >> 8) & 0xff;
    run_op<P, Sweep>(a, w0, op,
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

}  // namespace tpuamg_cycle
