// K2: one whole multigrid V/W cycle z = M b as ONE persistent cooperative
// launch.
//
// Replaces tpuamg/amg/grid_fused.py:_mega_kernel (the cycle of
// :_cycle_machine), which runs the whole cycle -- every level's Chebyshev
// steps, residuals, restrictions, the dense coarse solve and the
// prolongations -- as one sequential program on one TPU core, with the
// residuals of K1 (tpuamg/sparse/dia_pallas.py:_residual_kernel) inside
// it.  The earlier port (vcycle.cu's pieces and K1's residual form,
// sequenced from the host by amg/grid_fused.py::vcycle_sequenced) issues
// 78 launches per V-cycle at the bench path's 4 levels, and ~1,000 per
// W-cycle at n=256; at ~17-20 us of host per launch the cycle cost what
// its launches cost, with the card idle most of the time.
//
// Design for Hopper: the op program of amg/cycle_program.py, run by the
// device interpreter that K5 also runs (csrc/cycle_program.cuh: the table
// layouts, the fused ops, their barriers and traps), without K5's PCG
// loop.  Every block of a grid sized to be co-resident (SMs x 1 block of
// 512 threads, cudaLaunchCooperativeKernel) stages the two tables into
// shared memory and runs the cycle's ops once; dependent ops meet at
// cooperative_groups' grid.sync().  Level 0's right-hand side is the
// caller's pre-masked b, which the kernel only reads; z lands in level
// 0's x buffer 0 (vc._x[0]; compile_ops ends the cycle there).  Nothing
// is written inside the launch before the first op, so no barrier comes
// before it; the last op carries none, and the kernel ends there.
//
// Bound on an H100: bytes.  Inputs read once (every level's A, C and M
// planes, T, b) and z written once: 76 MB at the bench path (n=512, bf16
// planes and T), 0.023 ms at 3.35 TB/s.  The algorithm streams more:
// every Chebyshev step re-reads its level's planes: level 0's A planes
// are read 9 times per V-cycle of degree 4 (8 steps and the restriction).
// At level 0 a step is bandwidth (~36 MB at nflat 608,256 with 17 bf16
// A-offsets); on the small levels an op is a grid barrier and a few
// rounds of memory latency (~3 us).
//
// The launch is cooperative: a grid larger than can be co-resident fails
// (cudaErrorCooperativeLaunchTooLarge) and the wrapper raises; there is
// no fallback to the sequenced cycle.
#include "cycle_program.cuh"

namespace tpuamg_cyclep {

using namespace tpuamg_cycle;

// the host argument vector (amg/grid_fused.py::_CYCLE_ARGS)
enum ArgWord {
  aLevels = 0, aNLevels, aOps, aNOps, aB, aT, aBc, aXc, aPartial, aRowsC,
  aNc, aNSplit, kNArgs
};

struct Args {
  const long long* levels;
  const int* ops;
  Cycle cy;            // b0 = the caller's b
};

template <typename P>
__global__ void __launch_bounds__(kThreads) cycle_persistent_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  // the level table, then the op table, in dynamic shared memory
  extern __shared__ long long tables[];
  const int* ops = stage_tables(a.levels, a.cy.nlevels, a.ops, a.cy.nops,
                                tables);
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;
  run_cycle<P>(a.cy, ops, tables, grid, gtid, gstride);
}

inline const void* select(int planes_bf16) {
  return planes_bf16
             ? (const void*)(&cycle_persistent_kernel<__nv_bfloat16>)
             : (const void*)(&cycle_persistent_kernel<float>);
}

}  // namespace tpuamg_cyclep

// The table layouts this library was built with, for the host to check
// against amg/cycle_program.py.
extern "C" int tpuamg_cycle_persistent_layout(int* out4) {
  using namespace tpuamg_cyclep;
  out4[0] = kLevelWords;
  out4[1] = kOpWords;
  out4[2] = kNArgs;
  out4[3] = kMaxDiags;
  return 0;
}

// out2 = (resident blocks per SM, SMs) for the kernel with `smem` bytes
// of staged tables, on the current device.
extern "C" int tpuamg_cycle_persistent_occupancy(int planes_bf16, int smem,
                                                 int* out2) {
  using namespace tpuamg_cyclep;
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

// One cycle: args is the kNArgs-long host vector of pointers and sizes
// (amg/grid_fused.py::_CYCLE_ARGS).  Launched cooperatively on `grid`
// blocks of kThreads threads with smem bytes of dynamic shared memory
// (the level and op tables); a grid that cannot be co-resident returns
// cudaErrorCooperativeLaunchTooLarge and nothing runs.
extern "C" int tpuamg_cycle_persistent(const long long* args, int nargs,
                                       int planes_bf16, int grid, int smem,
                                       void* stream) {
  using namespace tpuamg_cyclep;
  const void* k = select(planes_bf16);
  if (nargs != kNArgs || grid < 1 || args[aNSplit] < 1 ||
      args[aNLevels] < 1 || args[aNLevels] > 255 || args[aNOps] < 1 ||
      smem != table_bytes(args[aNLevels], args[aNOps]))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t se = allow_smem(k, smem);
  if (se != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(se);
  }
  Args a;
  a.levels = reinterpret_cast<const long long*>(args[aLevels]);
  a.ops = reinterpret_cast<const int*>(args[aOps]);
  a.cy.nlevels = static_cast<int>(args[aNLevels]);
  a.cy.nops = static_cast<int>(args[aNOps]);
  a.cy.b0 = reinterpret_cast<const float*>(args[aB]);
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
