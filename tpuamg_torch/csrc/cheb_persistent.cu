// K3: one whole Chebyshev smoother sweep on one level of the unfused grid
// hierarchy as ONE persistent cooperative launch.
//
// Replaces tpuamg/sparse/dia_pallas.py:_cheb_kernel (via _cheb_call and
// FusedChebSmoother.smooth / .smooth_residual), which runs the sweep as ONE
// program on one TPU core: x, b, t and d stay in VMEM while the A and C
// planes stream block by block, and with want_r one more A pass gives
// r = b - A x_final.  The earlier port (csrc/cheb.cu, now
// cheb_sweep_sequenced) made two grid-wide launches per step, one more
// for r, and a copy of x: 2k + 2 launches per application at degree k.
//
// Design for Hopper: the sweep is a short op program
// (amg/cycle_program.py, SweepProgram) run by the interpreter that K5 and
// K2 share (csrc/cycle_program.cuh), in its sweep form (run_op<P, true>):
//  - iters x degree CHEB_STEP ops, fFirst on the first step of each
//    iteration, then with want_r one RESIDUAL op r = b - A x_final.  C is
//    the nodal block inverse (offsets -(F-1)..F-1, zero across node
//    blocks; the host refuses any other C), so where F divides 32 a step
//    is one op: t crosses lanes inside its node block by warp shuffles.
//    Other F split a step into RESIDUAL (t) and CHEB_APPLY, with a grid
//    barrier between them;
//  - a grid barrier after every op but the last, where the kernel ends;
//  - grid = SMs x 1 block of kThreads = 512 threads, co-resident
//    (cudaLaunchCooperativeKernel); a grid that cannot be refuses to
//    launch, and the wrapper raises: there is no fallback.
// The level table is built once per smoother: four rows of one level (the
// same planes, offsets, n, F and scratch), which differ only in what
// their x0, x1 and next-b words name.  The call's vectors (its x and b,
// the returned x and r) are launch arguments: the table names them by
// code (-(1 + CallVector)), and each block binds them in its own shared
// copy of the table when it stages it.  So no table is written per call,
// and x is never copied: the first step reads the caller's x, the steps
// then alternate between the returned x and the smoother's second buffer,
// ordered so that the last step writes the returned x.
//
// Bound on an H100: bytes.  Each pass does 2 flops per diagonal against 4
// (f32) or 2 (bf16) plane bytes, far below the card's float32 balance
// point, so the least time of the function is its inputs (A and C planes,
// x, b) read once and its outputs (x, r) written once over 3.35 TB/s.  The
// algorithm streams more: each step reads the A and C planes, x, b and d
// and writes x and d (13 MB per step at level 0 of route (c) at n=256, f32);
// the residual reads A, x and b and writes r.  On the small levels an op
// is a grid barrier and a few rounds of memory latency (~3 us).
#include "cycle_program.cuh"

namespace tpuamg_chebp {

using namespace tpuamg_cycle;

// the host argument vector (sparse/dia_kernels.py::_CHEB_ARGS)
enum ArgWord { aLevels = 0, aNLevels, aOps, aNOps, aX, aB, aXOut, aR, kNArgs };

// the call's vectors, which the level table names by the code -(1 + v)
// in a pointer word (amg/cycle_program.py::CALL_*)
enum CallVector { vX = 0, vB, vXOut, vR, kNCall };

struct Args {
  const long long* levels;
  const int* ops;
  Cycle cy;                   // b0 = the caller's b
  long long call[kNCall];     // the call's vectors, in CallVector order
};

template <typename P>
__global__ void __launch_bounds__(kThreads) cheb_persistent_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  // the level table, then the op table, in dynamic shared memory
  extern __shared__ long long tables[];
  const int* ops = stage_tables(a.levels, a.cy.nlevels, a.ops, a.cy.nops,
                                tables);
  // bind the call's vectors in this block's copy of the level table
  // (selected, not indexed: a dynamic index would copy the arguments to
  // local memory)
  for (int i = threadIdx.x; i < a.cy.nlevels * kLevelWords; i += kThreads) {
    const long long v = -1 - tables[i];
    if (i % kLevelWords <= kNextX1 && v >= 0 && v < kNCall)
      tables[i] = v == vX ? a.call[vX] : v == vB ? a.call[vB]
                : v == vXOut ? a.call[vXOut] : a.call[vR];
  }
  __syncthreads();
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;
  run_cycle<P, true>(a.cy, ops, tables, grid, gtid, gstride);
}

inline const void* select(int planes_bf16) {
  return planes_bf16
             ? (const void*)(&cheb_persistent_kernel<__nv_bfloat16>)
             : (const void*)(&cheb_persistent_kernel<float>);
}

}  // namespace tpuamg_chebp

// The table layouts this library was built with, for the host to check
// against amg/cycle_program.py.
extern "C" int tpuamg_cheb_persistent_layout(int* out4) {
  using namespace tpuamg_chebp;
  out4[0] = kLevelWords;
  out4[1] = kOpWords;
  out4[2] = kNArgs;
  out4[3] = kMaxDiags;
  return 0;
}

// out2 = (resident blocks per SM, SMs) for the kernel with `smem` bytes
// of staged tables, on the current device.
extern "C" int tpuamg_cheb_persistent_occupancy(int planes_bf16, int smem,
                                                int* out2) {
  using namespace tpuamg_chebp;
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

// One smoother application: args is the kNArgs-long host vector of
// pointers and sizes (sparse/dia_kernels.py::_CHEB_ARGS; r is 0 when the
// program has no RESIDUAL op).  Launched cooperatively on `grid` blocks of
// kThreads threads with smem bytes of dynamic shared memory (the level and
// op tables); a grid that cannot be co-resident returns
// cudaErrorCooperativeLaunchTooLarge and nothing runs.
extern "C" int tpuamg_cheb_persistent(const long long* args, int nargs,
                                      int planes_bf16, int grid, int smem,
                                      void* stream) {
  using namespace tpuamg_chebp;
  const void* k = select(planes_bf16);
  if (nargs != kNArgs || grid < 1 || args[aNLevels] < 1 ||
      args[aNLevels] > 255 || args[aNOps] < 1 ||
      smem != table_bytes(args[aNLevels], args[aNOps]))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t se = allow_smem(k, smem);
  if (se != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(se);
  }
  Args a = {};
  a.levels = reinterpret_cast<const long long*>(args[aLevels]);
  a.ops = reinterpret_cast<const int*>(args[aOps]);
  a.cy.nlevels = static_cast<int>(args[aNLevels]);
  a.cy.nops = static_cast<int>(args[aNOps]);
  a.cy.b0 = reinterpret_cast<const float*>(args[aB]);
  a.cy.nsplit = 1;
  a.call[vX] = args[aX];
  a.call[vB] = args[aB];
  a.call[vXOut] = args[aXOut];
  a.call[vR] = args[aR];
  void* kargs[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      k, dim3(grid), dim3(kThreads), kargs, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();   // clears a launch error
  return static_cast<int>(e != cudaSuccess ? e : last);
}
