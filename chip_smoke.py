#!/usr/bin/env python3
"""Drive tpuamg_torch's main path on one CUDA card and check it.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

The main path is bench.py's default workload, run by the port: the
bidomain 2D monolithic system at n=512 (526,338 dofs), the fused grid
hierarchy (preset metric_schwarz, V-cycle, Chebyshev degree 4,
coarse_dof=4096, bf16 storage of the cycle's planes, float32 compute),
and PCG with one outer DIA SpMV (kernel K1) and one whole cycle (kernel
K2, one launch) per iteration.

Phases, one line of numbers each:
  1. build the CUDA kernels (one nvcc call) and print -Xptxas -v;
  2. the card's name and power limit (nvidia-smi);
  3. K1 against its plain version on the outer operator (f32 planes) and
     on the level-0 bf16 planes, with times, its bound and the
     torch.sparse CSR yardstick;
  4. K2 (one whole cycle) against the plain torch cycle at n=512 (since
     the fifth slice: one launch, see below);
  5. the PCG solve of bench.py's protocol (gamma 1e6, tol 1e-12, maxiter
     50): iterations, reduction, s/iteration, nnz/s, launch counts;
  6. gamma 1, 1e6 and 1e8 at n=512 to tol 2e-5, f32 storage.
The second slice, solve_system's grid branch (problems/solve.py) and the
bidomain_2d driver, adds:
  7. K3 (the Chebyshev sweep) against its plain version on the
     route-(c) hierarchy at n=256, f32 storage;
  8. K5 (the PCG chunk) against its plain chunk at n=256 in the driver's
     configuration (metric_schwarz: W-cycle, coarse_dof 100, Chebyshev
     degree 3; gamma 1e6, f32); the route-(a) solve to 1e-8 beside the
     plain chunk's and route (b)'s on the same hierarchy, and the same
     pair at n=512;
  9. route (c), NL-AMLI(2), at n=256 to 1e-6 through solve_system, with
     the kernel classes and with pallas=False;
 10. refine at n=512 (V-cycle, coarse_dof 4096, f32, refine 4, inner tol
     2e-5, tol 1e-8) beside the TPU record;
 11. the driver, python -m tpuamg_torch.problems.bidomain_2d -backend grid
     -dtype float32 -nrefs 4 -gamma 1e6 -precond metric_mono, in-process
     in a temporary working directory.
The third slice, the distributed grid solve (dist/) on a one-rank NCCL
group (the card's machine has one card), adds:
 12. K6 (the sharded Chebyshev step, csrc/cheb_step.cu) on level 0 of the
     n=512 distributed hierarchy (gamma 1e6, f32), cut into 8 in-process
     shards with halos sliced from the whole vector: each shard's step
     against cheb_step_plain, and the shards' degree-3 sweep and residual
     against K3's sweep of the whole level;
 13. K7's counterpart (dia_spmv_pallas) on the n=512 outer operator and
     on synthetic DIAs with 1024-aligned and with arbitrary offsets,
     against dia_spmv_plain;
 14. distributed_grid_solve at n=512 (phase 5's system), V-cycle, tol
     1e-8, with the kernels and with pallas=False;
 15. the JAX record at n=64 on one rank: 18 iterations, nflat 15360,
     pallas_levels 4.
The fourth slice redesigns two kernels and extends two phases:
  8. K5 is one persistent cooperative launch per chunk
     (csrc/pcg_persistent.cu), the whole cycle inside it as an op program
     (amg/cycle_program.py): checked against the plain chunk and against
     the earlier sequenced chunk (csrc/pcg.cu around K2, timed beside
     it), and profiled; route (a) must make one launch per chunk and none
     of csrc/pcg.cu's;
 13. dia_spmv_pallas is one launch of K1's unpadded entry, no padded copy;
     the padded-x launch alone is timed beside it.
The fifth slice makes K2 one persistent cooperative launch per cycle
(csrc/cycle_persistent.cu, the op program through the interpreter it
shares with K5, csrc/cycle_program.cuh), with K1's residual form inside:
  4. the one-launch cycle against its plain version (run_program_plain)
     and against the earlier host-sequenced cycle (vcycle_sequenced),
     both timed, launches per cycle (1), its device time and idle share,
     and single ops (the level-0 Chebyshev step warm and cold, the coarse
     solve) against their bounds;
  5, 8, 10. route (b), route (a)'s first cycle and refine make one
     cycle_persistent launch per cycle and none of the sequenced cycle's
     (K2_STEPS, K1's dia_residual).
The sixth slice makes K3 one persistent cooperative launch per smoother
application (csrc/cheb_persistent.cu, a sweep program through the same
interpreter):
  1. the new kernel's ptxas lines;
  7. at every level of the route-(c) hierarchy, smooth and
     smooth_residual at iters 1 and 2 against the plain sweep and against
     the earlier design (cheb_sweep_sequenced, csrc/cheb.cu), one launch
     per application and none of the earlier design's; both designs timed
     in turns (events) and by their device time (profiler), with the
     ops' streamed bytes beside the inputs-once bound;
  9. route (c) launches only the new K3, whose device time per executed
     iteration the profile shows;
 12. K6's device time per step (profiler) beside its event time; its
     shards' sweep against the new K3.
The seventh slice, the algebraic metric-AMG path (no hand-written kernel:
its device work is torch ops on ELL matrices, as the JAX package's is XLA
ops), adds:
  3, 12. K1 on the outer operator and K6's level-0 step by device time,
     warm and after a 128 MB write (cold L2);
 16. solve_system(A, b, "metric_mono", ...) at n=512 (phase 5's system)
     with the driver's preset metric_schwarz, float64, tol 1e-8: within
     1 iteration of the JAX table's 11, cond <= 3, the true residual;
     set-up seconds, ms per PCG iteration, device operations per cycle
     (profiler), device busy per iteration and the idle share; the
     native amgkit library loaded;
 17. the preconditioner, the ELL matvec and one GS and one Schwarz sweep
     on the card against the same hierarchy on the CPU (1e-12, f64);
 18. the other -precond modes (hazmath, hazmath_Schwarz, hazmath_HEM,
     metric, metric_hazmath, diag) and metric_mono with MINRES and GMRES
     at n=64, each converged, beside the committed tables;
 19. the driver with its default -backend algebraic: -precond metric_mono
     -nrefs 4 -gamma 1e8, iterations 6/7/8/8 +- 1, H1 rates in [0.9, 1.1].
The eighth slice stops PCG, MINRES and K5 at the crossing iterate (K5
leaves its chunk there: every block evaluates the stop test after the
barrier that completes an iteration's r.z), and adds the 3D-1D pipeline
(no new kernel: the algebraic route's device work is torch ops):
  5, 8, 9, 14, 16, 20. executed iterations beside the counted ones,
     within the design's bound (check_executed: counted, or counted + n
     when a chunk of n ran past the crossing and was run again), and
     whether the target executed <= counted + 1 held;
  8. K5 given a stop test (type 2) leaves the chunk at the crossing, held
     against the plain chunk's exit: iterations run, rows, x;
 20. the 3D-1D pipeline at mesh_n 16 (radius 0.2, the default synthetic
     neuron, input_metric.dat: CG, stop type 1, tol 1e-6) at gamma 1 and
     1e8: python -m tpuamg_torch.problems.emi_3d1d -dump 1, then
     run_solver_3d1d on the card, then -load_solution, in a temporary
     directory; the card's solve against the CPU's on the same dump
     (iterations equal, x to 1e-10 at gamma 1 and 1e-8 at gamma 1e8,
     X3D1D_LIMIT) and the true relative residual <= 1e-6
     (host, f64); set-up and solve seconds, ms per iteration, torch
     operations per cycle (profiler).
The ninth slice, the structured 3D-1D route (setup_structured, the
footprint operator, the host float64 tail, the factored outer operator)
and K1's wide entry (more than 64 diagonals, offsets from a device
array), adds:
 20. phase 20 names -route algebraic: with coords.npy on the card
     run_solver_3d1d now takes the structured route;
 21. run_solver_3d1d on the card at mesh_n 16 (phase 20's dumps), gamma 1
     and 1e8, its default route there (structured: f32 storage, f64
     Krylov, refine 3, the factored outer operator with AD on K1, the
     host tail): the route, slots and real dofs, AD's band count, K1
     wide launches per iteration, the K3/K1 branch of each window level,
     set-up, pass iterations, ms per iteration with the host tail's
     share, the true residual; converged, true residual <= 1e-6, pass
     iterations within 1 of the CPU run of the same keywords; K1's wide
     entry on AD (matvec and residual) against plain, by events and
     profiler device time warm and after a 128 MB write, beside its bytes
     bound and CSR @ on the same operator; K3 on a structured window
     hierarchy (bidomain 2D n=127) against plain.
The tenth slice redesigns K1's wide entry as a walk over a tile-compacted
layout of the operator's nonzeros (sparse/dia_tiles.py, csrc/dia_tiles.cu;
the planes design of the ninth slice stays as dia_spmv_wide_planes, for
comparison only):
  1. the wide kernel's ptxas lines;
 21. the solves launch only the tile walk (dia_spmv_wide), each
     operator's layout built once, never the planes design; on AD (matvec
     and residual) and on each wide Morton level of the n=127 hierarchy,
     the walk against plain and bit for bit against the planes design,
     by events and profiler device time, warm and cold, beside the
     planes design and CSR @, with the bound counted the guide's way
     (nonzero values, x, y, b once; the padded planes as a second
     figure).
Then a JSON line {"kernels": [...]}, the nvidia-smi line, and, last, the
result line {"ok": true, "device": {...}}.  Any failed check raises, and
the script exits nonzero; a watchdog ends it, with a traceback and a
nonzero code, if it runs past WATCHDOG_S seconds.
"""
import faulthandler
import sys

WATCHDOG_S = 900
faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from dataclasses import replace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 512
GAMMA = 1e6
CHEB = 4
COARSE = 4096
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 peak outside tensor cores
# the launches of csrc/vcycle.cu that one host-sequenced cycle makes
# (with K1's dia_residual): the one-launch cycle makes none of them
K2_STEPS = ("cheb_apply", "restrict", "prolong", "coarse_gemv",
            "coarse_reduce")
SEQUENCED = K2_STEPS + ("dia_residual",)
# the launches of csrc/pcg.cu that one chunk makes
K5_STEPS = ("pcg_rz", "pcg_pq", "pcg_xr", "pcg_finish")
N2 = 256            # the second slice's full width: route (a)'s largest n
ROUTE_A_CHUNK = 32  # pcg_fused's chunk, which route (a) keeps
# The committed CPU f64 tables of the JAX package's driver (metric_mono,
# kappa 2/3, tol 1e-8): PCG iterations by dofs at gamma 1e6 and, for
# ncells 32..256, at gamma 1e8
# (docs/sample_results/bidomain_2d/iters_precondmetric_mono_*).
ALG_ITERS_1E6 = {2178: 6, 8450: 8, 33282: 10, 132098: 10, 526338: 11}
ALG_ITERS_1E8 = (6, 7, 8, 8)
# the same tables at 8,450 dofs (n=64), gamma 1e6, for the other modes
# with a table; metric and metric_hazmath take metric_mono's preset in the
# driver, so its count
ALG_ITERS_N64 = {"hazmath": 39, "hazmath_Schwarz": 12, "hazmath_HEM": 8,
                 "metric": 8, "metric_hazmath": 8, "metric_mono": 8}
N_SMALL = 64        # the seventh slice's small modes
MESH_N = 16         # the 3D-1D pipeline's bulk mesh (phase 20)
# Phase 20's limit on x, card against CPU, by gamma.  The card and the
# CPU differ in summation order only, and at gamma 1e8 (cond(A) 1.6e9 at
# mesh_n 8) one unit of rounding in each product of A and M moves the
# crossing iterate by about 1e-9 (scripts/torch_rounding_floor.py 3d1d:
# 3.3e-10 .. 1.1e-9 at mesh_n 8; PERF.md gives the mesh_n 16 figures).
# The card has read 5.1e-10 .. 2.3e-9 there and 2e-14 .. 4e-14 at gamma 1
# (PERF.md, the eighth slice), so 1e-8 is 4.4x the largest reading.
X3D1D_LIMIT = {"1": 1e-10, "100000000": 1e-8}
# The TPU record of refine at n=512, gamma 1e6 (V-cycle, coarse_dof 4096,
# f32, refine 4, inner tol 2e-5): Krylov iterations per refinement pass,
# from docs/sample_results/bidomain_2d_tpu_gamma_n512.txt (the 1e6 row),
# written by scripts/tpu_gamma_sweep.py.
TPU_REFINE_PASSES = (13, 21)


def say(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def timed_ms(fn, reps, dev, warmup=2):
    """Mean ms per call: CUDA events on the card, the host clock else."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def library_ms(make_call, reps, dev):
    """Time one PyTorch call as a yardstick; None where it does not run."""
    try:
        call = make_call()
        return timed_ms(call, reps, dev)
    except Exception as e:  # the yardstick is not part of the port
        say(f"  library call unavailable: {type(e).__name__}: {e}")
        return None


def csr_of(A_host, dev):
    return torch.sparse_csr_tensor(
        torch.as_tensor(A_host.indptr, dtype=torch.int64),
        torch.as_tensor(A_host.indices.astype(np.int64)),
        torch.as_tensor(A_host.data, dtype=torch.float32),
        size=A_host.shape).to(dev)


def ptxas_summary(log):
    """'kernel: N registers, spills' per compiled entry."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            short = re.sub(r"^_Z\w*?(\d+)", "", name)[:40] or name
            out.append(f"{short}:{m.group(1)}r")
            name = None
    spills, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            fn = m.group(1)
        elif "spill" in line and not re.search(r"\b0 bytes spill", line):
            spills.append(f"{fn}: {line.strip()}")
    return out, spills


def ptxas_of(log, kernel):
    """-Xptxas -v's lines (registers, shared memory, stack, spills) for
    each compiled entry whose name contains `kernel`."""
    out, keep = [], False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            keep = kernel in m.group(1)
            if keep:
                out.append(re.sub(r"^_Z\w*?\d+(pcg|cycle|cheb)", r"\1",
                                  m.group(1)))
        elif keep and ("Used" in line or "spill" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def system(gamma, n):
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, gamma)
    A, b, sizes, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2),
                                p)
    return A, b


def slice_setup(A, n, dev, coarse, storage=torch.bfloat16):
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.amg.grid_fused import (setup_grid_fused,
                                             grid_system_fused)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type="v", coarse_dof=coarse)
    vc, slots, nflat = setup_grid_fused(
        A, (n + 1, n + 1), F=2, params=prm, cheb_degree=CHEB,
        storage_dtype=storage, device=dev)
    Aop = grid_system_fused(A, slots, nflat, dtype=torch.float32, device=dev)
    return vc, slots, Aop


def scatter(b, slots, nflat, dev):
    bk = torch.zeros(nflat, dtype=torch.float32)
    bk[torch.as_tensor(slots)] = torch.as_tensor(b, dtype=torch.float32)
    return bk.to(dev)


def run(n=N, device="cuda", coarse=COARSE, n2=N2, nrefs=4,
        n_small=N_SMALL, alg_nrefs=4, mesh_n=MESH_N):
    """All phases; returns the kernels list.  device='cpu' rehearses the
    script's own logic with the plain versions (no kernels, no counts);
    n2, nrefs, n_small, alg_nrefs and mesh_n shrink the later slices'
    phases for such a rehearsal."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (KernelDIA, dia_spmv,
                                                 dia_spmv_plain)
    from tpuamg_torch.amg.cycle_program import run_program_plain
    from tpuamg_torch.amg.grid_fused import (vcycle, vcycle_plain,
                                             vcycle_sequenced)
    from tpuamg_torch.krylov import pcg

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    t_all = time.perf_counter()

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    if on_card:
        kernels.lib()
        info = kernels.BUILD_INFO
        regs, spills = ptxas_summary(info["ptxas"])
        say(f"[1 build] {time.perf_counter() - t0:.2f} s "
            f"(nvcc {info['seconds']:.2f} s, cached={info['cached']}) "
            f"ptxas: {' '.join(regs)} spills: {spills or 'none'}")
        say("[1 build] the persistent K5: " + " | ".join(
            ptxas_of(info["ptxas"], "pcg_persistent")))
        say("[1 build] the one-launch K2: " + " | ".join(
            ptxas_of(info["ptxas"], "cycle_persistent")))
        say("[1 build] the one-launch K3: " + " | ".join(
            ptxas_of(info["ptxas"], "cheb_persistent")))
        say("[1 build] K1's wide entry (tile walk): " + " | ".join(
            ptxas_of(info["ptxas"], "dia_tiles")))
    else:
        say("[1 build] skipped (rehearsal on the CPU)")

    # ---- 2. device -----------------------------------------------------
    smi = nvidia_smi() if on_card else "cpu rehearsal"
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    say(f"[2 device] {name} | nvidia-smi: {smi}")

    # ---- problem + hierarchy (host setup, timed as set-up) -------------
    t0 = time.perf_counter()
    A, b = system(GAMMA, n)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    vc, slots, Aop = slice_setup(A, n, dev, coarse)
    sync(dev)
    t_setup = time.perf_counter() - t0
    S0 = vc.spec.levels[0]
    say(f"[setup] n={n} dofs={A.shape[0]} nnz={A.nnz} assembly "
        f"{t_asm:.2f} s hierarchy {t_setup:.2f} s levels="
        f"{[(S.lead, S.K, S.rows, len(S.offsA)) for S in vc.spec.levels]} "
        f"coarse_n={vc.coarse_n} nc={vc.spec.nc} "
        f"T={tuple(vc.T.shape)} {vc.T.dtype} outer offsets="
        f"{len(Aop.offsets)} nflat={vc.nflat}")
    kern = []

    # ---- 3. K1 ---------------------------------------------------------
    nflat = vc.nflat
    x = torch.as_tensor(rng.standard_normal(nflat), dtype=torch.float32
                        ).to(dev)
    bb = torch.as_tensor(rng.standard_normal(nflat), dtype=torch.float32
                         ).to(dev)
    reps = 200 if on_card else 2
    for label, offs, planes, rhs in (
            ("dia_spmv", Aop.offsets, Aop.planes, None),
            ("dia_residual", S0.offsA, vc.A_planes[0], bb)):
        before = kernels.LAUNCHES[label]
        y_k = dia_spmv(offs, planes, x, rhs).clone()
        y_p = dia_spmv_plain(offs, planes, x, rhs)
        sync(dev)
        check(not on_card or kernels.LAUNCHES[label] == before + 1,
              f"{label} kernel not launched")
        abs_err = float((y_k - y_p).abs().max())
        rel = abs_err / float(y_p.abs().max())
        check(np.isfinite(rel) and rel <= 1e-5,
              f"{label} vs plain: rel err {rel:.3e} > 1e-5")
        out = torch.empty_like(x)
        ms = timed_ms(lambda: dia_spmv(offs, planes, x, rhs, out), reps, dev)
        plain_ms = timed_ms(lambda: dia_spmv_plain(offs, planes, x, rhs),
                            max(reps // 20, 2), dev)
        item = planes.element_size()
        nbytes = planes.numel() * item + 4 * nflat * (
            2 + (rhs is not None))
        flops = 2 * planes.numel() + (nflat if rhs is not None else 0)
        bms, by = bound_ms(nbytes, flops)
        csr_host = KernelDIA(offs, planes, (nflat, nflat), 0).to_host()

        def make_library_call(M_host=csr_host, rhs=rhs):
            M = csr_of(M_host, dev)
            if rhs is None:
                return lambda: M @ x
            return lambda: torch.addmv(rhs, M, x, beta=1.0, alpha=-1.0)
        lib = library_ms(make_library_call, reps, dev)
        if on_card and rhs is None:
            # the kernel's own device time, warm and after a 128 MB write
            wc = warm_cold_us(lambda: dia_spmv(offs, planes, x, rhs, out),
                              "dia_sweep_kernel", dev)
            say(f"[3 K1 {label}] device time per launch: warm "
                f"{fmt_us(wc[False])}, cold (after a 128 MB write) "
                f"{fmt_us(wc[True])} | bound {bms * 1e3:.2f} us")
        say(f"[3 K1 {label}] planes {tuple(planes.shape)} {planes.dtype} "
            f"max_abs_err {abs_err:.3e} rel {rel:.3e} | kernel {ms:.5f} ms "
            f"plain {plain_ms:.5f} ms csr-library {lib} ms | bound "
            f"{bms:.5f} ms ({by}, {nbytes} B, {flops} flop) "
            f"-> {bms / ms:.3f} of bound")
        kern.append(dict(name=label, route="cuda",
                         source="tpuamg_torch/csrc/dia.cu",
                         replaces=("tpuamg/sparse/dia_pallas.py:198"
                                   if rhs is None else
                                   "tpuamg/sparse/dia_pallas.py:210"),
                         launches=0, max_abs_err=abs_err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib))

    # ---- 4. K2: one whole cycle, one launch ----------------------------
    bm = torch.as_tensor(rng.standard_normal(nflat), dtype=torch.float32
                         ).to(dev) * vc.mask_flat
    prog = vc.program()
    kernels.reset_launches()
    z_k = vcycle(vc, bm).clone()
    sync(dev)
    per_cycle = dict(kernels.LAUNCHES)
    if on_card:
        check(per_cycle == {"cycle_persistent": 1, "vcycle": 1},
              f"cycle: one cycle_persistent launch, got {per_cycle}")
    z_p = run_program_plain(prog, vc, bm).clone()
    sync(dev)
    abs_err = float((z_k - z_p).abs().max())
    rel = rel_err(z_k, z_p)
    check(bool(torch.isfinite(z_k).all()) and rel <= 1e-4,
          f"cycle vs plain: rel err {rel:.3e} > 1e-4")
    reps = 200 if on_card else 1
    seq = dict(ms=None, abs_err=None, text="not run (CUDA only)")
    if on_card:
        # the earlier design on the same inputs: K2's pieces and K1's
        # residual form, one host launch each; timed in turns with the
        # one-launch cycle (sequenced, one launch, one launch, sequenced)
        kernels.reset_launches()
        z_s = vcycle_sequenced(vc, bm).clone()
        sync(dev)
        per_seq = dict(kernels.LAUNCHES)
        check(all(per_seq.get(k, 0) > 0 for k in SEQUENCED)
              and not per_seq.get("cycle_persistent"),
              f"sequenced cycle launches {per_seq}")
        rel_s, rel_ks = rel_err(z_s, z_p), rel_err(z_k, z_s)
        check(rel_s <= 1e-4 and rel_ks <= 1e-4,
              f"sequenced vs plain {rel_s:.3e}, one launch vs sequenced "
              f"{rel_ks:.3e} > 1e-4")
        t_seq = [timed_ms(lambda: vcycle_sequenced(vc, bm), 20, dev)]
        t_one = [timed_ms(lambda: vcycle(vc, bm), reps, dev)
                 for _ in range(2)]
        t_seq.append(timed_ms(lambda: vcycle_sequenced(vc, bm), 20, dev))
        ms = float(np.mean(t_one))
        seq["ms"] = float(np.mean(t_seq))
        seq["abs_err"] = float((z_s - z_p).abs().max())
        seq["text"] = (
            f"{t_seq[0]:.4f}/{t_seq[1]:.4f} ms, "
            f"{sum(v for k, v in per_seq.items() if k != 'vcycle')} "
            f"launches (vs plain {rel_s:.3e}; one launch vs sequenced "
            f"{rel_ks:.3e})")
    else:
        ms = timed_ms(lambda: vcycle(vc, bm), reps, dev)
        t_one = [ms]
    plain_ms = timed_ms(lambda: run_program_plain(prog, vc, bm),
                        5 if on_card else 1, dev)
    work = cycle_work(vc)
    bms, by = bound_ms(work["inputs"], work["flops"])
    say(f"[4 K2 vcycle] one launch: rel err {rel:.3e} max_abs_err "
        f"{abs_err:.3e} | cycle {'/'.join(f'{t:.4f}' for t in t_one)} ms "
        f"plain {plain_ms:.4f} ms | sequenced {seq['text']} | launches "
        f"per cycle {sum(v for k, v in per_cycle.items() if k != 'vcycle')}"
        f" {per_cycle} | program: {len(prog)} ops, {prog.grid_barriers()} "
        f"grid barriers, {prog.shared_bytes()} B of tables, nsplit "
        f"{prog.nsplit} ({-(-vc.spec.nc // prog.nsplit)} columns), "
        f"{prog.counts()} | bound {bms:.5f} ms ({by}; inputs once "
        f"{work['inputs']} B, {work['flops']} flop); streamed per cycle "
        f"{work['stream']} B = "
        f"{work['stream'] / HBM_BYTES_PER_S * 1e3:.5f} ms (sequenced "
        f"{work['stream_sequenced']} B = "
        f"{work['stream_sequenced'] / HBM_BYTES_PER_S * 1e3:.5f} ms)")
    kern.append(dict(name="vcycle", route="cuda",
                     source="tpuamg_torch/csrc/cycle_persistent.cu",
                     replaces="tpuamg/amg/grid_fused.py:553",
                     launches=0, max_abs_err=abs_err, ms=ms,
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None))
    kern.append(dict(name="vcycle_sequenced", route="cuda",
                     source="tpuamg_torch/csrc/vcycle.cu",
                     replaces="tpuamg/amg/grid_fused.py:553",
                     launches=0, max_abs_err=seq["abs_err"], ms=seq["ms"],
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None))
    if on_card:
        cycle_profile(vc, bm, ms, work)
        op_times(vc, bm, dev)

    # ---- 5. the PCG solve (bench.py protocol) --------------------------
    bk = scatter(b, slots, nflat, dev)
    sync(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = pcg(Aop, bk, M=vc, tol=1e-12, maxiter=50, chunk=50)
    sync(dev)
    t_pcg = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    red = float(res.residuals[-1] / res.residuals[0])
    xs = res.x.double().cpu().numpy()[slots]
    true_rel = float(np.linalg.norm(b - A.matvec(xs)) / np.linalg.norm(b))
    it = max(res.niters, 1)
    nnz_iter = A.nnz + vc.cycle_nnz()
    say(f"[5 pcg] gamma {GAMMA:g} iterations {res.niters} (TPU record: 49; "
        f"executed {res.executed} in {res.host_reads - 1} chunks) "
        f"reduction {red:.3e} true rel residual {true_rel:.3e} "
        f"cond {res.cond:.3f} | {t_pcg:.4f} s, {t_pcg / it * 1e3:.4f} "
        f"ms/iteration, nnz/iteration {nnz_iter}, nnz/s "
        f"{nnz_iter * it / t_pcg:.4e} | launches {counts}")
    check(np.isfinite(red) and red <= 1e-10,
          f"pcg reduction {red:.3e} > 1e-10")
    check(np.all(np.isfinite(xs)), "pcg solution not finite")
    check_executed("pcg", res.niters, res.executed)
    if on_card:
        # one cycle launch per outer SpMV: each iteration's and the
        # start's; nothing of the sequenced cycle
        check(counts.get("cycle_persistent", 0) == counts.get("vcycle", 0)
              == counts.get("dia_spmv", 0) > 0
              and not any(counts.get(k) for k in SEQUENCED),
              f"pcg: one cycle_persistent launch per iteration and none of "
              f"{SEQUENCED} expected, got {counts}")
        for row in kern:
            row["launches"] = counts.get(
                "cycle_persistent" if row["name"] == "vcycle"
                else row["name"], 0)
    t0 = time.perf_counter()
    res2 = pcg(Aop, bk, M=vc, tol=1e-12, maxiter=50, chunk=50)
    sync(dev)
    t_pcg2 = time.perf_counter() - t0
    say(f"[5 pcg again] iterations {res2.niters} {t_pcg2:.4f} s, "
        f"{t_pcg2 / max(res2.niters, 1) * 1e3:.4f} ms/iteration")
    if on_card:
        prof = profile_pcg(Aop, vc, bk, 5, dev)
        if prof is None:
            say("[5 profile] not measured: the profiler saw no device time")
        else:
            rows_p, busy, wall = prof
            per_it = busy / 6      # 5 iterations + the initial M r0, A x0
            say(f"[5 profile] 5 PCG iterations: device busy {busy:.1f} us "
                f"({per_it:.1f} us per iteration, the start counted as "
                f"one) of {wall * 1e6:.1f} us wall "
                f"with the profiler on; device idle share without it: "
                f"run 1 {1 - per_it * it / (t_pcg * 1e6):.4f}, run 2 "
                f"{1 - per_it * it / (t_pcg2 * 1e6):.4f}")
            say("[5 profile] device us by kernel (calls, total): "
                + json.dumps([(k, c, round(u, 1)) for k, c, u in rows_p]))
    # the same solve with the plain cycle and plain SpMV, as a reference
    Aplain = (lambda v: dia_spmv_plain(Aop.offsets, Aop.planes, v))
    t0 = time.perf_counter()
    ref = pcg(Aplain, bk, M=lambda r: vcycle_plain(vc, r * vc.mask_flat
                                                   ).clone(),
              tol=1e-12, maxiter=50, chunk=50)
    sync(dev)
    red_p = float(ref.residuals[-1] / ref.residuals[0])
    say(f"[5 pcg plain reference] iterations {ref.niters} reduction "
        f"{red_p:.3e} | {time.perf_counter() - t0:.3f} s")
    check(abs(ref.niters - res.niters) <= 2,
          f"pcg iterations {res.niters} vs plain {ref.niters}")

    # ---- 6. the gamma sweep to 2e-5 ------------------------------------
    # f32 storage, as the JAX package's gamma sweep ran it: bf16 planes
    # and T leave the cycle indefinite at gamma 1e8 (r.z < 0 at n=64..128)
    del vc, Aop
    sweep = {}
    for g in (1.0, GAMMA, 1e8):
        t0 = time.perf_counter()
        Ag, bg = (A, b) if g == GAMMA else system(g, n)
        vg, sg, Aog = slice_setup(Ag, n, dev, coarse, torch.float32)
        t_set = time.perf_counter() - t0
        kernels.reset_launches()
        t0 = time.perf_counter()
        rg = pcg(Aog, scatter(bg, sg, vg.nflat, dev), M=vg, tol=2e-5,
                 maxiter=60, chunk=8)
        sync(dev)
        xg = rg.x.double().cpu().numpy()[sg]
        tr = float(np.linalg.norm(bg - Ag.matvec(xg)) / np.linalg.norm(bg))
        sweep[g] = rg.niters
        say(f"[6 gamma {g:g}] iterations {rg.niters} converged "
            f"{rg.converged} true rel residual {tr:.3e} | setup "
            f"{t_set:.2f} s solve {time.perf_counter() - t0:.4f} s "
            f"launches {dict(kernels.LAUNCHES)}")
        check(rg.converged and 0 < rg.niters <= 30 and tr < 1e-3,
              f"gamma {g:g}: {rg.niters} iterations, converged "
              f"{rg.converged}")
        if on_card:
            check(kernels.LAUNCHES["vcycle"] > 0
                  and kernels.LAUNCHES["dia_spmv"] > 0,
                  f"gamma {g:g}: kernels not launched")
    say(f"[6 sweep] iterations to 2e-5 by gamma {sweep} "
        f"(TPU first pass: 19/13/9) | total "
        f"{time.perf_counter() - t_all:.1f} s")

    # ---- 7-11: the second slice ----------------------------------------
    slice2(dev, kern, A, b, n, n2, nrefs)
    say(f"[11 done] total {time.perf_counter() - t_all:.1f} s")

    # ---- 12-15: the third slice ----------------------------------------
    slice3(dev, kern, A, b, n)
    say(f"[15 done] total {time.perf_counter() - t_all:.1f} s")

    # ---- 16-19: the seventh slice, the algebraic metric-AMG path -------
    algebraic_slice(dev, A, b, n, n_small, alg_nrefs)
    say(f"[19 done] total {time.perf_counter() - t_all:.1f} s")

    # ---- 20: the eighth slice, the 3D-1D pipeline ----------------------
    for gamma in ("1", "100000000"):
        phase20(dev, mesh_n, gamma)
    say(f"[20 done] total {time.perf_counter() - t_all:.1f} s")

    # ---- 21: the ninth slice, the structured 3D-1D route ---------------
    phase21(dev, kern, mesh_n)
    say(f"[21 done] total {time.perf_counter() - t_all:.1f} s")
    return kern


def check_executed(what, counted, executed, chunk=32):
    """Executed iterations against counted ones.  What the design
    guarantees: executed is counted, or counted + n when one chunk of n
    iterations ran past the crossing and was run again from its saved
    start, n at most the chunk cap and at most the iterations before it
    (krylov.cg.pcg; K5 leaves its chunk at the crossing, so route (a)
    runs no such chunk).  A count past that bound fails.  Whether the
    solve met the target of at most two preconditioner applications more
    than counted (z0's and one more: executed <= counted + 1) is
    printed, since the chunk lengths are predicted from the data."""
    bound = counted + min(chunk, max(counted - 1, 0))
    check(executed <= bound,
          f"{what}: {executed} iterations executed for {counted} counted "
          f"(past the design's bound {bound})")
    say(f"[executed] {what}: {executed} for {counted} counted, "
        f"{'within' if executed <= counted + 1 else 'PAST'} the target "
        f"counted + 1 (bound {bound})")


def rel_err(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def clone_all(out):
    return tuple(t.clone() for t in out)


def chunk_errs(got, ref, chunk, what):
    """(stats rows 0-1 rel err, x rel err, x max abs err) of two chunks
    (x, r, p, z, stats) from one start; fails past 1e-5 (rows) or 1e-3
    (x), phase 8's thresholds."""
    rows = got[4][:2, :5].double()
    rows_r = ref[4][:2, :5].double()
    row_err = float(torch.linalg.vector_norm(rows - rows_r)
                    / torch.linalg.vector_norm(rows_r))
    x_err = rel_err(got[0], ref[0])
    check(np.isfinite(row_err) and row_err <= 1e-5,
          f"K5 vs {what}: stats rows 0-1 rel err {row_err:.3e} > 1e-5")
    check(np.isfinite(x_err) and x_err <= 1e-3,
          f"K5 vs {what}: x after {chunk} iterations rel err {x_err:.3e}")
    return row_err, x_err, float((got[0] - ref[0]).abs().max())


def sweep_stream(sm, iters, want_r):
    """Bytes the one-launch K3's ops stream per application (op by op:
    planes and vectors read once, neighbouring x entries from cache, what
    each op writes once), and the earlier design's two passes per step,
    its residual pass and its copy of x."""
    from tpuamg_torch.amg import cycle_program as cp
    n = sm.n
    pa = sm.planesA.numel() * sm.planesA.element_size()
    pc = sm.planesC.numel() * sm.planesC.element_size()
    new = 0
    for op in sm.program().ops(iters, want_r):
        if op.kind == cp.RESIDUAL:           # A, x, b in; r (or t) out
            new += pa + 12 * n
        elif op.kind == cp.CHEB_STEP:        # A, C, b, x (and d) in;
            new += pa + pc + (16 if op.first else 20) * n     # d, x out
        else:                                # CHEB_APPLY: C, t, x (d) in
            new += pc + (16 if op.first else 20) * n
    k = sm.degree * iters
    old = 8 * n + k * (pa + 12 * n) + k * (pc + 20 * n) + want_r * (
        pa + 12 * n)
    return new, old


def phase7_level(dev, lv, sm, rng):
    """Phase 7 on one level of the route-(c) hierarchy: the one-launch K3
    (smooth and smooth_residual, iters 1 and 2) against the plain sweep
    and the earlier design; one launch per application; both designs
    timed in turns (events) and by their device time (profiler).  Returns
    the kernels-line rows of the two designs at this level."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (cheb_sweep_plain,
                                                 cheb_sweep_sequenced)
    on_card = dev.type == "cuda"
    nd = sm.n
    x = torch.as_tensor(rng.standard_normal(nd), dtype=torch.float32
                        ).to(dev)
    bb = torch.as_tensor(rng.standard_normal(nd), dtype=torch.float32
                         ).to(dev)
    planes = (sm.offsA, sm.planesA, sm.offsC, sm.planesC)
    cheb = (sm.theta, sm.coefs, sm.degree)

    def seq(iters=1):
        return cheb_sweep_sequenced(*planes, x, bb, *cheb, iters, True)
    errs, limits, abs_err, abs_seq = {}, {}, 0.0, None
    for iters in (1, 2):
        kernels.reset_launches()
        xs_k, r_k = sm.smooth_residual(None, x, bb, iters)
        x2_k = sm.smooth(None, x, bb, iters)
        sync(dev)
        counts = dict(kernels.LAUNCHES)
        if on_card:
            check(counts == {"cheb_sweep": 2}, f"K3 level {lv}: one launch "
                  f"per application and no cheb_sweep_sequenced launch, got "
                  f"{counts}")
        xs_p, r_p = cheb_sweep_plain(*planes, x, bb, *cheb, iters, True)
        # the f32 floor: the plain sweep's own distance from the same
        # sweep in float64 (on the coarsest levels, where x_new is a few
        # times smaller than x, it passes 1e-5 for random inputs)
        xs_64, r_64 = cheb_sweep_plain(
            sm.offsA, sm.planesA.double(), sm.offsC, sm.planesC.double(),
            x.double(), bb.double(), *cheb, iters, True)
        floor = {"x": rel_err(xs_p, xs_64), "r": rel_err(r_p, r_64)}
        got = {"smooth": (x2_k, xs_p, "x"),
               "smooth_residual x": (xs_k, xs_p, "x"),
               "smooth_residual r": (r_k, r_p, "r")}
        abs_err = max(abs_err, float((xs_k - xs_p).abs().max()),
                      float((r_k - r_p).abs().max()))
        if on_card:
            xs_s, r_s = seq(iters)
            sync(dev)
            got.update({"sequenced x": (xs_s, xs_p, "x"), "sequenced r":
                        (r_s, r_p, "r"), "vs sequenced x": (xs_k, xs_s, "x"),
                        "vs sequenced r": (r_k, r_s, "r")})
            abs_seq = max(abs_seq or 0.0, float((xs_s - xs_p).abs().max()),
                          float((r_s - r_p).abs().max()))
        for key, (a, b, what) in got.items():
            errs[f"{key} it{iters}"] = rel_err(a, b)
            limits[f"{key} it{iters}"] = max(1e-5, 2 * floor[what])
    bad = {k: (e, limits[k]) for k, e in errs.items()
           if not (np.isfinite(e) and e <= limits[k])}
    check(not bad, f"K3 level {lv}: rel errors past max(1e-5, twice the "
          f"f32 floor): {bad}")
    reps = 100 if on_card else 1
    t_new = [timed_ms(lambda: sm.smooth_residual(None, x, bb), reps, dev)]
    t_seq = []
    dev_us = {"one launch": "not measured", "sequenced": "not measured"}
    if on_card:
        # in turns: sequenced, one launch, one launch, sequenced
        t_seq = [timed_ms(seq, reps, dev)]
        t_new.append(timed_ms(lambda: sm.smooth_residual(None, x, bb),
                              reps, dev))
        t_seq.append(timed_ms(seq, reps, dev))
        for label, fn in (("one launch", lambda: sm.smooth_residual(
                None, x, bb)), ("sequenced", seq)):
            prof = profile_busy(lambda: [fn() for _ in range(20)], dev)
            if prof is not None:
                dev_us[label] = prof[1] / 20
    ms = float(np.mean(t_new))
    ms_s = timed_ms(lambda: sm.smooth(None, x, bb), reps, dev)
    plain_ms = timed_ms(lambda: cheb_sweep_plain(*planes, x, bb, *cheb, 1,
                                                 True),
                        max(reps // 10, 1), dev) if lv == 0 else None
    pa = sm.planesA.numel() * sm.planesA.element_size()
    pc = sm.planesC.numel() * sm.planesC.element_size()
    k = sm.degree
    nbytes = pa + pc + 4 * nd * 4            # x, b in; x, r out
    flops = (k + 1) * 2 * sm.planesA.numel() + k * (
        2 * sm.planesC.numel() + 3 * nd)
    bms, by = bound_ms(nbytes, flops)
    new, old = sweep_stream(sm, 1, True)
    prog = sm.program()

    def us(v):
        return v if isinstance(v, str) else f"{v:.2f} us"
    say(f"[7 K3 level {lv}] n={nd} offsets A {len(sm.offsA)} C "
        f"{len(sm.offsC)} {sm.planesA.dtype} degree {k} F {sm.F}: "
        f"{len(prog.ops(1, True))} ops, {prog.shared_bytes(1, True)} B of "
        f"tables | max rel err {max(errs.values()):.3e}, limits "
        f"{min(limits.values()):.3e}-{max(limits.values()):.3e} "
        f"{json.dumps({k: float('%.3e' % e) for k, e in errs.items()})} "
        f"max_abs_err {abs_err:.3e} | smooth_residual one launch "
        f"{'/'.join(f'{t:.5f}' for t in t_new)} ms (device "
        f"{us(dev_us['one launch'])}), sequenced "
        f"{'/'.join(f'{t:.5f}' for t in t_seq) or 'not run'} ms (device "
        f"{us(dev_us['sequenced'])}, {2 * k + 1} launches and a copy of "
        f"x), smooth {ms_s:.5f} ms, plain "
        f"{'not timed' if plain_ms is None else f'{plain_ms:.5f} ms'} | bound "
        f"{bms:.5f} ms ({by}, inputs once {nbytes} B); streamed by the "
        f"ops {new} B = {new / HBM_BYTES_PER_S * 1e3:.5f} ms (sequenced "
        f"{old} B = {old / HBM_BYTES_PER_S * 1e3:.5f} ms) | library: none")
    row = dict(name="cheb_sweep", route="cuda",
               source="tpuamg_torch/csrc/cheb_persistent.cu",
               replaces="tpuamg/sparse/dia_pallas.py:436", launches=0,
               max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=None)
    row_seq = dict(name="cheb_sweep_sequenced", route="cuda",
                   source="tpuamg_torch/csrc/cheb.cu",
                   replaces="tpuamg/sparse/dia_pallas.py:436", launches=0,
                   max_abs_err=abs_seq,
                   ms=float(np.mean(t_seq)) if t_seq else None,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=None)
    return row, row_seq


def slice2(dev, kern, A512, b512, n512, n2, nrefs):
    """Phases 7-11 (module docstring).  A512, b512: phase 5's system."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid import grid_system, setup_grid
    from tpuamg_torch.krylov import pcg
    from tpuamg_torch.amg.cycle_program import RESID_RESTRICT
    from tpuamg_torch.amg.grid_fused import (pcg_chunk, pcg_chunk_plain,
                                             pcg_chunk_sequenced, pcg_fused,
                                             persistent_grid,
                                             setup_grid_fused_pcg,
                                             vcycle_plain, vcycle_sequenced)
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.problems.solve import solve_system
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    A, b = system(GAMMA, n2)
    sizes = (A.shape[0] // 2,) * 2
    grid2 = ((n2 + 1, n2 + 1), 2)
    say(f"[7 setup] n={n2} dofs={A.shape[0]} nnz={A.nnz} assembly "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 7. K3 against its plain version and its earlier design -------
    nl_amli = replace(PRESETS["metric_schwarz"], cycle_type="nl_amli",
                      amli_degree=2, dtype="float32")
    t0 = time.perf_counter()
    prec, gslots, nd = setup_grid(A, grid2[0], F=2, params=nl_amli,
                                  dtype=torch.float32, device=dev)
    sync(dev)
    t_set = time.perf_counter() - t0
    say(f"[7 setup] route-(c) hierarchy {t_set:.2f} s: level rows "
        f"{[L.smoother.n for L in prec.levels]}")
    rows = [phase7_level(dev, lv, L.smoother, rng)
            for lv, L in enumerate(prec.levels)]
    k3 = rows[0][0]
    kern.extend(rows[0])        # level 0's: the one launch, the sequenced

    # ---- 8. K5 against its plain chunk; routes (a) and (b) -------------
    drv = replace(PRESETS["metric_schwarz"], dtype="float32")
    t0 = time.perf_counter()
    fp, slots, nflat = setup_grid_fused_pcg(A, grid2[0], F=2, params=drv,
                                            device=dev)
    sync(dev)
    t_set = time.perf_counter() - t0
    say(f"[8 setup] n={n2} route-(a) hierarchy {t_set:.2f} s: "
        f"{len(fp.vc.spec.levels)} levels, cycle "
        f"{fp.vc.spec.cycle}, coarse_n {fp.vc.coarse_n}, outer offsets "
        f"{len(fp.Q.offsets)}, nflat {nflat}")
    vc = fp.vc
    bk = scatter(b, slots, nflat, dev)
    bm = bk * vc.mask_flat
    # the chunk starts from the host-sequenced cycle's z0, the start K5's
    # earlier readings had (PERF.md), so that its errors compare with them
    z0 = (vcycle_sequenced if on_card else vcycle_plain)(vc, bm).clone()
    chunk = 8

    def start():
        return (torch.zeros_like(bm), bm.clone(), torch.zeros_like(bm),
                z0.clone(), torch.full((1,), -1.0, device=dev))

    kernels.reset_launches()
    got_k = clone_all(pcg_chunk(fp, *start(), chunk))
    sync(dev)
    per_chunk = dict(kernels.LAUNCHES)
    if on_card:
        check(per_chunk == {"pcg_chunk": 1},
              f"K5: one persistent launch per chunk, got {per_chunk}")
    got_p = clone_all(pcg_chunk_plain(fp, *start(), chunk))
    row_err, x_err, abs_err = chunk_errs(got_k, got_p, chunk, "plain")
    ms = timed_ms(lambda: pcg_chunk(fp, *start(), chunk), 5 if on_card
                  else 1, dev, warmup=1)
    plain_ms = timed_ms(lambda: pcg_chunk_plain(fp, *start(), chunk), 1,
                        dev, warmup=0)
    seq = dict(ms=None, abs_err=None, text="not run (CUDA only)")
    if on_card:
        # the earlier design on the same run: 3 pcg.cu launches per
        # iteration around K2's host-sequenced cycle
        kernels.reset_launches()
        got_s = clone_all(pcg_chunk_sequenced(fp, *start(), chunk))
        sync(dev)
        per_seq = dict(kernels.LAUNCHES)
        check(per_seq.get("pcg_chunk_sequenced") == 1
              and per_seq.get("pcg_pq") == chunk
              and per_seq.get("vcycle") == chunk
              and not per_seq.get("cycle_persistent"),
              f"sequenced chunk launches {per_seq}")
        s_rows, s_x, s_abs = chunk_errs(got_s, got_p, chunk, "plain")
        k_rows, k_x, _ = chunk_errs(got_k, got_s, chunk, "sequenced")
        seq["ms"] = timed_ms(lambda: pcg_chunk_sequenced(fp, *start(),
                                                         chunk), 2, dev,
                             warmup=1)
        seq["abs_err"] = s_abs
        seq["text"] = (
            f"{seq['ms']:.4f} ms, {sum(per_seq.values()) - 1} launches "
            f"(sequenced vs plain: rows {s_rows:.3e} x {s_x:.3e}; "
            f"persistent vs sequenced: rows {k_rows:.3e} x {k_x:.3e})")
    nbytes, flops, stream = chunk_work(fp, chunk)
    bms, by = bound_ms(nbytes, flops)
    prog = fp.program()
    grid = persistent_grid(fp) if on_card else None
    say(f"[8 K5 pcg_chunk] {chunk} iterations from rz_prev=-1, one "
        f"persistent launch (grid {grid} = (blocks, resident per SM, SMs) "
        f"x 512 threads): stats rows 0-1 rel err {row_err:.3e}, "
        f"x rel err {x_err:.3e} max_abs_err {abs_err:.3e} | chunk "
        f"{ms:.4f} ms ({ms / chunk:.4f} ms/iteration) plain {plain_ms:.4f} "
        f"ms | sequenced {seq['text']} | bound {bms:.5f} ms ({by}, inputs "
        f"once {nbytes} B); streamed {stream} B = "
        f"{stream / HBM_BYTES_PER_S * 1e3:.5f} ms | program: {len(prog)} "
        f"ops per cycle, {prog.grid_barriers()} grid barriers, "
        f"{prog.shared_bytes()} B of tables, {prog.counts()} | library: "
        f"none")
    k5 = dict(name="pcg_chunk", route="cuda",
              source="tpuamg_torch/csrc/pcg_persistent.cu",
              replaces="tpuamg/amg/grid_fused.py:679", launches=0,
              max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
              bound_by=by, library_ms=None)
    kern.append(k5)
    kern.append(dict(name="pcg_chunk_sequenced", route="cuda",
                     source="tpuamg_torch/csrc/pcg.cu",
                     replaces="tpuamg/amg/grid_fused.py:679", launches=0,
                     max_abs_err=seq["abs_err"], ms=seq["ms"],
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None))
    if on_card:
        prof = profile_busy(lambda: pcg_chunk(fp, *start(), chunk), dev)
        if prof is None:
            say("[8 profile chunk] not measured: the profiler saw no "
                "device time")
        else:
            rows_prof, busy, wall = prof
            kern_us = sum(u for kk, _, u in rows_prof
                          if "pcg_persistent" in kk)
            say(f"[8 profile chunk] device busy {busy:.1f} us (the "
                f"persistent kernel {kern_us:.1f} us) of {wall * 1e6:.1f} "
                f"us wall with the profiler on; idle share inside the "
                f"chunk without it {1 - busy / (ms * 1e3):.4f} | "
                + json.dumps([(kk, c, round(u, 1))
                              for kk, c, u in rows_prof[:6]]))

    # K5's exit at the crossing against the plain chunk's: a stop test
    # (type 2) between the rows with the widest gap, so that f32 noise
    # cannot move the crossing
    res_w = got_p[4][:chunk, 2].double().cpu().numpy()
    gaps = [np.min(res_w[:j]) / res_w[j] for j in range(1, chunk - 1)]
    at = 1 + int(np.argmax(gaps))
    stop = (2, float(np.sqrt(np.min(res_w[:at]) * res_w[at])), 0.0)
    kernels.reset_launches()
    got_e = clone_all(pcg_chunk(fp, *start(), chunk, stop))
    sync(dev)
    if on_card:
        check(dict(kernels.LAUNCHES) == {"pcg_chunk": 1},
              f"K5 early exit: one launch, got {dict(kernels.LAUNCHES)}")
    got_ep = clone_all(pcg_chunk_plain(fp, *start(), chunk, stop))
    carry_k = got_e[4][chunk, 2:4].tolist()
    carry_p = got_ep[4][chunk, 2:4].tolist()
    check(carry_k == carry_p == [at + 1.0, 1.0],
          f"K5 early exit: (iterations run, why) {carry_k}, plain "
          f"{carry_p}, expected {[at + 1, 1]}")
    e_rows, e_x, e_abs = chunk_errs(got_e, got_ep, chunk,
                                    "plain, early exit")
    ms_e = timed_ms(lambda: pcg_chunk(fp, *start(), chunk, stop),
                    5 if on_card else 1, dev, warmup=1)
    say(f"[8 K5 early exit] stop type 2 between rows {at - 1} and {at} "
        f"(gap x{gaps[at - 1]:.2f}): the kernel ran {carry_k[0]:g} of "
        f"{chunk} iterations (plain {carry_p[0]:g}), why {carry_k[1]:g}: "
        f"stats rows 0-1 rel err {e_rows:.3e}, x rel err {e_x:.3e} "
        f"max_abs_err {e_abs:.3e} | {ms_e:.4f} ms "
        f"({ms_e / (at + 1):.4f} ms per iteration run)")

    # the route-(a) solve through solve_system, as the driver runs it
    kernels.reset_launches()
    t0 = time.perf_counter()
    rep = solve_system(A, b, "metric_mono", sizes, params=PRESETS[
        "metric_schwarz"], tol=1e-8, maxiter=500, dtype=np.float32,
        grid=grid2, device=dev)
    t_solve = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    tr = float(np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b))
    red = float(rep.residuals[-1] / rep.residuals[0])
    check(rep.route == "a" and rep.converged and np.isfinite(tr)
          and tr < 1e-5, f"route (a) at n={n2}: route {rep.route}, "
          f"converged {rep.converged}, true rel residual {tr:.3e}")
    # pcg_fused's chunks stop at the crossing: one launch per chunk of
    # up to ROUTE_A_CHUNK iterations
    chunks = -(-rep.niters // ROUTE_A_CHUNK)
    check_executed("route (a)", rep.niters, rep.executed)
    if on_card:
        check(counts.get("pcg_chunk") == chunks
              and not any(counts.get(kk) for kk in K5_STEPS + SEQUENCED)
              and counts.get("vcycle") == counts.get("cycle_persistent")
              == 1,
              f"route (a): {chunks} persistent launches, one K2 launch "
              f"(z0), none of {K5_STEPS + SEQUENCED} expected, got "
              f"{counts}")
        k5["launches"] = counts["pcg_chunk"]
    ran = max(rep.executed, 1)
    it = max(rep.niters, 1)
    nnz_iter = A.nnz + vc.cycle_nnz()
    say(f"[8 route a] n={n2} solve_system: iterations {rep.niters} "
        f"(executed {rep.executed} in {chunks} chunks) reduction {red:.3e} "
        f"true rel residual {tr:.3e} cond {rep.cond:.3f} | setup "
        f"{rep.t_setup:.2f} s solve {rep.t_solve:.4f} s "
        f"({rep.t_solve / it * 1e3:.3f} ms per counted iteration, "
        f"{rep.t_solve / ran * 1e3:.3f} per executed iteration; wall "
        f"{t_solve:.2f} s) nnz/iteration {nnz_iter} nnz/s "
        f"{nnz_iter * it / rep.t_solve:.4e} | launches {counts}")
    if on_card:
        t0 = time.perf_counter()
        pcg_fused(fp, bk, tol=1e-8, maxiter=500)
        sync(dev)
        t_a = time.perf_counter() - t0
        prof = profile_busy(lambda: pcg_fused(fp, bk, tol=1e-8,
                                              maxiter=500), dev)
        if prof is None:
            say("[8 profile] not measured: the profiler saw no device time")
        else:
            rows_prof, busy, wall = prof
            say(f"[8 profile] route (a) pcg_fused at n={n2} ({ran} "
                f"iterations executed + the start's cycle): device busy "
                f"{busy:.1f} us of {wall * 1e6:.1f} us wall with the "
                f"profiler on; without it {t_a * 1e6:.1f} us, idle share "
                f"{1 - busy / (t_a * 1e6):.4f}")
            say("[8 profile] device us by kernel (calls, total): "
                + json.dumps([(kk, c, round(u, 1))
                              for kk, c, u in rows_prof[:12]]))
    plain_its = route_pair(fp, bk, vc, A, b, slots, n2, dev, rep.niters,
                           plain=True)
    check(abs(plain_its - rep.niters) <= 1,
          f"route (a) {rep.niters} vs plain chunk {plain_its} iterations")
    del fp, vc, bk, bm, z0

    # the same pair at n=512 on phase 5's system
    t0 = time.perf_counter()
    fp5, slots5, nflat5 = setup_grid_fused_pcg(A512, (n512 + 1,) * 2, F=2,
                                               params=drv, device=dev)
    sync(dev)
    say(f"[8 setup n={n512}] {time.perf_counter() - t0:.2f} s, "
        f"{len(fp5.vc.spec.levels)} levels")
    bk5 = scatter(b512, slots5, nflat5, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res5 = pcg_fused(fp5, bk5, tol=1e-8, maxiter=500)
    sync(dev)
    t5 = time.perf_counter() - t0
    counts5 = dict(kernels.LAUNCHES)
    chunks5 = -(-res5.niters // ROUTE_A_CHUNK)
    if on_card:
        check(counts5.get("pcg_chunk") == chunks5
              and counts5.get("cycle_persistent") == 1
              and not any(counts5.get(kk) for kk in K5_STEPS + SEQUENCED),
              f"route (a) at n={n512}: launches {counts5}")
    check_executed(f"route (a) at n={n512}", res5.niters, res5.executed)
    ran5 = max(res5.executed, 1)
    x5 = res5.x.double().cpu().numpy()[slots5]
    tr5 = float(np.linalg.norm(b512 - A512.matvec(x5))
                / np.linalg.norm(b512))
    prog5 = fp5.program()
    say(f"[8 route a n={n512}] iterations {res5.niters} (executed "
        f"{ran5} in {chunks5} chunks) true rel residual {tr5:.3e} | "
        f"{t5:.3f} s, {t5 / max(res5.niters, 1) * 1e3:.3f} ms per counted "
        f"iteration, {t5 / ran5 * 1e3:.3f} per executed iteration (and "
        f"cycle) | program: {len(prog5)} ops per cycle, "
        f"{prog5.grid_barriers()} grid barriers, level visits per cycle "
        f"{sum(op.kind == RESID_RESTRICT for op in prog5.ops)} | launches "
        f"{counts5}")
    check(res5.converged and np.isfinite(tr5) and tr5 < 1e-5,
          f"route (a) at n={n512}: true rel residual {tr5:.3e}")
    check(res5.converged, f"route (a) at n={n512} did not converge")
    route_pair(fp5, bk5, fp5.vc, A512, b512, slots5, n512, dev,
               res5.niters, plain=False, ms_a=t5 / max(res5.niters, 1))
    del fp5, bk5

    # ---- 9. route (c): NL-AMLI(2) --------------------------------------
    res_c = {}
    for pallas in (None, False):
        kernels.reset_launches()
        rep_c = solve_system(A, b, "metric_mono", sizes, params=nl_amli,
                             tol=1e-6, maxiter=200, dtype=np.float32,
                             grid=grid2, pallas=pallas, device=dev)
        counts = dict(kernels.LAUNCHES)
        trc = float(np.linalg.norm(b - A.matvec(rep_c.x))
                    / np.linalg.norm(b))
        itc = max(rep_c.niters, 1)
        res_c[pallas] = rep_c
        check_executed(f"route (c) pallas={pallas}", rep_c.niters,
                       rep_c.executed)
        say(f"[9 route c pallas={pallas}] n={n2} NL-AMLI(2): iterations "
            f"{rep_c.niters} (executed {rep_c.executed}) converged "
            f"{rep_c.converged} true rel residual "
            f"{trc:.3e} | setup {rep_c.t_setup:.2f} s solve "
            f"{rep_c.t_solve:.3f} s ({rep_c.t_solve / itc * 1e3:.2f} "
            f"ms/iteration) | per iteration: cheb_sweep "
            f"{counts.get('cheb_sweep', 0) / itc:.1f}, cheb_sweep_sequenced "
            f"{counts.get('cheb_sweep_sequenced', 0) / itc:.1f}, "
            f"K1 dia_residual "
            f"{counts.get('dia_residual', 0) / itc:.1f}, K1 dia_spmv "
            f"{counts.get('dia_spmv', 0) / itc:.1f}")
        check(rep_c.route == "c" and rep_c.converged and trc < 1e-4,
              f"route (c) pallas={pallas}: converged {rep_c.converged}, "
              f"true rel residual {trc:.3e}")
        if on_card and pallas is None:
            for kname in ("cheb_sweep", "dia_residual", "dia_spmv"):
                check(counts.get(kname, 0) > 0,
                      f"route (c): kernel {kname} not launched")
            check(not counts.get("cheb_sweep_sequenced"),
                  f"route (c) launched the sequenced K3: {counts}")
            k3["launches"] = cheb_counts = counts["cheb_sweep"]
        if pallas is False:
            check(counts.get("cheb_sweep", 0) == 0
                  and counts.get("cheb_sweep_sequenced", 0) == 0,
                  "route (c) pallas=False launched K3")
    check(abs(res_c[None].niters - res_c[False].niters) <= 2,
          f"route (c) kernels {res_c[None].niters} vs plain "
          f"{res_c[False].niters} iterations")
    if on_card:
        # phase 7's hierarchy is the one route (c) builds: profile three
        # PCG iterations on it
        Aop_c = grid_system(A, gslots, dtype=torch.float32, device=dev)
        b_c = scatter(b, gslots, nd, dev)
        kernels.reset_launches()
        prof = profile_busy(lambda: pcg(Aop_c, b_c, M=prec.matvec,
                                        tol=0.0, maxiter=3, chunk=3), dev)
        per_cycle = kernels.LAUNCHES["cheb_sweep"] / 4
        if prof is None:
            say("[9 profile] not measured: the profiler saw no device time")
        else:
            rows_prof, busy, wall = prof
            per_it = busy / 4      # 3 iterations + the start's M r0
            ran_c = cheb_counts / max(per_cycle, 1)
            idle = 1 - per_it * ran_c / (res_c[None].t_solve * 1e6)
            k3_us = sum(u for kk, _, u in rows_prof
                        if "cheb_persistent" in kk) / 4
            old_k3 = [kk for kk, _, _ in rows_prof
                      if "cheb_t_kernel" in kk or "cheb_d_kernel" in kk]
            check(not old_k3, f"route (c) ran the sequenced K3: {old_k3}")
            say(f"[9 profile] route (c), 3 iterations: device busy "
                f"{busy:.1f} us ({per_it:.1f} us per iteration, the start "
                f"counted as one; K3 {k3_us:.1f} us of it in {per_cycle:g} "
                f"launches) of {wall * 1e6:.1f} us wall with the "
                f"profiler on; {per_cycle:g} K3 launches per cycle, "
                f"{ran_c:g} cycles executed in the solve; idle share "
                f"without it {idle:.4f}")
            say("[9 profile] device us by kernel (calls, total): "
                + json.dumps([(kk, c, round(u, 1))
                              for kk, c, u in rows_prof[:12]]))
    del prec

    # ---- 10. refine at n=512 -------------------------------------------
    v4096 = replace(PRESETS["metric_schwarz"], dtype="float32",
                    cycle_type="v", coarse_dof=4096)
    kernels.reset_launches()
    rep_r = solve_system(A512, b512, "metric_mono",
                         (A512.shape[0] // 2,) * 2, tol=1e-8, maxiter=200,
                         grid=((n512 + 1,) * 2, 2), params=v4096,
                         dtype=np.float32, refine=4, inner_tol=2e-5,
                         device=dev)
    say(f"[10 refine] n={n512} route {rep_r.route}: true rel residual "
        f"{rep_r.r_norm:.3e} converged {rep_r.converged} pass_iters "
        f"{'+'.join(map(str, rep_r.pass_iters))} (TPU record "
        f"{'+'.join(map(str, TPU_REFINE_PASSES))}) | setup "
        f"{rep_r.t_setup:.2f} s solve {rep_r.t_solve:.3f} s | launches "
        f"{dict(kernels.LAUNCHES)}")
    if on_card:
        counts = kernels.LAUNCHES
        check(counts["cycle_persistent"] == counts["vcycle"] > 0
              and not any(counts[kk] for kk in SEQUENCED),
              f"refine: one cycle_persistent launch per cycle and none of "
              f"{SEQUENCED} expected, got {dict(counts)}")
    check(rep_r.converged and rep_r.r_norm <= 1e-8,
          f"refine: true rel residual {rep_r.r_norm:.3e} > 1e-8")
    if n512 == N:
        check(len(rep_r.pass_iters) == len(TPU_REFINE_PASSES) and all(
            abs(a - r) <= 3 for a, r in zip(rep_r.pass_iters,
                                            TPU_REFINE_PASSES)),
            f"refine passes {rep_r.pass_iters} vs TPU record "
            f"{TPU_REFINE_PASSES}")

    # ---- 11. the driver ------------------------------------------------
    run_driver(dev, nrefs)


# docs/sample_results/dist_scaling.txt, ndev 1: bidomain 2D n=64, f32,
# V-cycle, gamma 1e6, tol 1e-8 (scripts/dist_scaling.py)
DIST_RECORD = dict(n=64, iterations=18, nflat=15360, pallas_levels=4)
DIST_SHARDS = 8         # the in-process shards of phase 12


def slice3(dev, kern, A512, b512, n512):
    """Phases 12-15 (module docstring), on a one-rank NCCL group (gloo for
    a CPU rehearsal) that this function starts and ends."""
    import torch.distributed as dist
    from tpuamg_torch.dist import (device_mesh, distributed_grid_solve,
                                   setup_distributed_grid)
    mesh = device_mesh(None if dev.type == "cuda" else "cpu")
    try:
        dims = (n512 + 1,) * 2
        t0 = time.perf_counter()
        prob = setup_distributed_grid(A512, b512, dims, F=2, mesh=mesh)
        sync(dev)
        say(f"[12 setup] n={n512} distributed hierarchy on "
            f"{mesh.size} rank ({dist.get_backend()}) "
            f"{time.perf_counter() - t0:.2f} s: {prob.info}, level rows "
            f"{[L.A.shape[0] for L in prob.prec.levels]}")
        k6 = phase12(dev, kern, prob)
        k_pad = phase13(dev, kern, prob)
        phase14(dev, prob, A512, b512, dims, mesh, k6, k_pad)
        del prob
        phase15(dev, mesh)
    finally:
        dist.destroy_process_group()


def phase12(dev, kern, prob):
    """K6 on level 0, in-process shards against plain and against K3."""
    from tpuamg_torch import kernels
    from tpuamg_torch.dist.dist_kernels import (ShardedChebSmoother,
                                                cheb_step, cheb_step_plain,
                                                halo_shards)
    from tpuamg_torch.sparse.dia_kernels import cheb_sweep, dia_spmv
    on_card = dev.type == "cuda"
    sm = prob.prec.levels[0].smoother
    check(isinstance(sm, ShardedChebSmoother),
          f"level 0 smoother is {type(sm).__name__}")
    n, h, F, k = sm.n, sm.h, sm.F, sm.degree
    pA, pC, oA, oC = sm.planesA, sm.planesC, sm.offsA, sm.offsC
    nsh = DIST_SHARDS
    check(n % (nsh * F) == 0, f"level 0 ({n} rows) does not cut into "
          f"{nsh} shards of whole node blocks")
    nl = n // nsh
    rows = [slice(r * nl, (r + 1) * nl) for r in range(nsh)]
    pAs = [pA[:, s].contiguous() for s in rows]
    pCs = [pC[:, s].contiguous() for s in rows]
    rng = np.random.default_rng(12)

    def vec(m):
        return torch.as_tensor(rng.standard_normal(m), dtype=torch.float32
                               ).to(dev)
    x, bb, d = vec(n), vec(n), vec(n)
    bs = [bb[s].contiguous() for s in rows]
    # each shard's step, a first and a later one, against plain (the
    # errors over the level: shards of ghost rows are all zero)
    errs, abs_err = [], 0.0
    before = kernels.LAUNCHES["cheb_step"]
    xhs = halo_shards(x, h, nsh)
    for first, s_, c_ in sm.steps[:2]:
        got = {"kernel": [], "plain": []}
        for r, xh in enumerate(xhs):
            args = (oA, pAs[r], oC, pCs[r], xh, h, bs[r],
                    d[rows[r]].contiguous(), first, s_, c_)
            got["kernel"].append(torch.cat(cheb_step(*args, F)))
            got["plain"].append(torch.cat(cheb_step_plain(*args)))
        xk, xp = torch.cat(got["kernel"]), torch.cat(got["plain"])
        errs.append(rel_err(xk, xp))
        abs_err = max(abs_err, float((xk - xp).abs().max()))
    sync(dev)
    check(not on_card or kernels.LAUNCHES["cheb_step"] == before + 2 * nsh,
          "cheb_step: one launch per shard step")
    check(all(np.isfinite(e) and e <= 1e-5 for e in errs),
          f"K6 vs plain: rel errors up to {max(errs):.3e} > 1e-5")
    # the shards' degree-k sweep and residual against K3's whole sweep
    theta = 1.0 / sm.steps[0][1]
    coefs = tuple((a_, c_) for _, a_, c_ in sm.steps[1:])
    ds = [torch.zeros(nl, device=dev) for _ in rows]
    xs = x.clone()
    for first, s_, c_ in sm.steps:
        xhs = halo_shards(xs, h, nsh)
        xs = torch.cat([cheb_step(oA, pAs[r], oC, pCs[r], xhs[r], h, bs[r],
                                  ds[r], first, s_, c_, F, d_out=ds[r])[0]
                        for r in range(nsh)])
    rs = torch.cat([dia_spmv(oA, pAs[r], xh, bs[r], x_pad=h)
                    for r, xh in enumerate(halo_shards(xs, h, nsh))])
    before = kernels.LAUNCHES["cheb_sweep"]
    x3, r3 = cheb_sweep(oA, pA, oC, pC, x, bb, theta, coefs, k, 1, True)
    check(not on_card or kernels.LAUNCHES["cheb_sweep"] == before + 1,
          "phase 12: K3's sweep of the whole level is one launch")
    y1, r1 = sm.smooth_residual(None, x, bb)
    y1, r1 = y1.clone(), r1.clone()
    y0 = sm.smooth(None, x, bb).clone()
    sync(dev)
    vs_k3 = {"shards x": rel_err(xs, x3), "shards r": rel_err(rs, r3),
             "smooth_residual x": rel_err(y1, x3),
             "smooth_residual r": rel_err(r1, r3), "smooth": rel_err(y0, x3)}
    check(all(np.isfinite(e) and e <= 1e-5 for e in vs_k3.values()),
          f"sharded sweep vs K3: rel errors {vs_k3} > 1e-5")
    # one step on the whole level, as the one-rank smoother launches it
    xh = torch.zeros(n + 2 * h, device=dev)
    xh[h:h + n] = x
    dd, xo = d.clone(), torch.empty_like(x)
    _, a1, c1 = sm.steps[1]
    reps = 200 if on_card else 2
    ms = timed_ms(lambda: cheb_step(oA, pA, oC, pC, xh, h, bb, dd, False,
                                    a1, c1, F, x_out=xo, d_out=dd), reps,
                  dev)
    plain_ms = timed_ms(lambda: cheb_step_plain(oA, pA, oC, pC, xh, h, bb,
                                                dd, False, a1, c1),
                        max(reps // 20, 2), dev)
    ms_sr = timed_ms(lambda: sm.smooth_residual(None, x, bb), reps // 2 or 1,
                     dev)
    # the kernel's own device time per step, apart from the host's cost
    # of each launch (the event time above is over back-to-back launches)
    dev_us, cold_us = "not measured", "not measured"
    if on_card:
        wc = warm_cold_us(lambda: cheb_step(
            oA, pA, oC, pC, xh, h, bb, dd, False, a1, c1, F, x_out=xo,
            d_out=dd), "cheb_step_kernel", dev, reps=20)
        dev_us, cold_us = wc[False], wc[True]
    s_b = pA.element_size()
    nbytes = (len(oA) + len(oC)) * n * s_b + 4 * (n + 2 * h) + 16 * n
    flops = 2 * (len(oA) + len(oC)) * n + 4 * n
    bms, by = bound_ms(nbytes, flops)
    say(f"[12 K6 cheb_step] level 0 n={n} halo {h} F={F} offsets A "
        f"{len(oA)} C {len(oC)} {pA.dtype}: {nsh} shards, steps vs plain "
        f"max rel err {max(errs):.3e} max_abs_err {abs_err:.3e}; vs K3 "
        f"{vs_k3} | step {ms:.5f} ms, device time "
        f"{fmt_us(dev_us)} per step warm, {fmt_us(cold_us)} cold (after a "
        f"128 MB write), plain {plain_ms:.5f} ms | bound "
        f"{bms:.5f} ms ({by}, "
        f"{nbytes} B) -> {bms / ms:.3f} of bound by events"
        + ("" if isinstance(dev_us, str) else
           f", {bms * 1e3 / dev_us:.3f} by device time") + ("" if isinstance(
               cold_us, str) else f" ({bms * 1e3 / cold_us:.3f} cold)")
        + f" | smooth_residual (degree {k}: {k} exchanges + K6, 1 exchange + "
        f"K1 padded residual) {ms_sr:.5f} ms | library: none")
    row = dict(name="cheb_step", route="cuda",
               source="tpuamg_torch/csrc/cheb_step.cu",
               replaces="tpuamg/dist/pallas_dist.py:186", launches=0,
               max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=None)
    kern.append(row)
    return row


def phase13(dev, kern, prob):
    """K7's counterpart: dia_spmv_pallas, K1 on the unpadded x; beside it
    the padded-x launch alone, the distributed outer SpMV's entry."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia import DIA
    from tpuamg_torch.sparse.dia_kernels import (dia_spmv, dia_spmv_pallas,
                                                 dia_spmv_plain)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(13)
    Aop = prob.A
    outer = DIA(Aop.offsets, Aop.planes, Aop.shape, Aop.nnz)
    n = Aop.shape[0]
    check(Aop.planes.shape[1] == n, "one rank holds the whole operator")
    ns = 1 << 20
    synth = {
        "1024-aligned": (-4096, -1024, 0, 1024, 3072),
        "arbitrary": (-1155, -1027, -130, -3, -1, 0, 1, 3, 127, 1026, 1155)}
    cases = [("outer n=%d" % n, outer)]
    for label, offs in synth.items():
        planes = torch.as_tensor(rng.standard_normal((len(offs), ns)),
                                 dtype=torch.float32).to(dev)
        cases.append((label, DIA(offs, planes, (ns, ns), 0)))
    errs, abs_err = {}, 0.0
    for label, D in cases:
        x = torch.as_tensor(rng.standard_normal(D.shape[0]),
                            dtype=torch.float32).to(dev)
        before = dict(kernels.LAUNCHES)
        yk = dia_spmv_pallas(D, x)
        yp = dia_spmv_plain(D.offsets, D.data, x)
        sync(dev)
        got = {k: kernels.LAUNCHES[k] - before.get(k, 0)
               for k in ("dia_spmv", "dia_spmv_pad")}
        check(not on_card or got == {"dia_spmv": 1, "dia_spmv_pad": 0},
              f"dia_spmv_pallas: one unpadded K1 launch, got {got}")
        errs[label] = float((yk - yp).abs().max() / yp.abs().max())
        abs_err = max(abs_err, float((yk - yp).abs().max()))
    check(all(np.isfinite(e) and e <= 1e-5 for e in errs.values()),
          f"K7 counterpart vs plain: {errs} > 1e-5")
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(dev)
    reps = 200 if on_card else 2
    ms = timed_ms(lambda: dia_spmv_pallas(outer, x), reps, dev)
    # the padded-x launch alone, on a buffer padded once
    pad = max(abs(o) for o in outer.offsets)
    xp = torch.zeros(n + 2 * pad, device=dev)
    xp[pad:pad + n] = x
    y = torch.empty_like(x)
    ms_pad = timed_ms(lambda: dia_spmv(outer.offsets, outer.data, xp,
                                       out=y, x_pad=pad), reps, dev)
    check(not on_card or torch.equal(y, dia_spmv_pallas(outer, x)),
          "the padded-x launch and dia_spmv_pallas differ")
    plain_ms = timed_ms(lambda: dia_spmv_plain(outer.offsets, outer.data, x),
                        max(reps // 20, 2), dev)
    # the kernel's own device time, apart from the host's per-call cost
    dev_us = "not measured"
    if on_card:
        prof = profile_busy(lambda: [dia_spmv_pallas(outer, x)
                                     for _ in range(20)], dev)
        if prof is not None:
            dev_us = "%.2f us" % (sum(u for kk, _, u in prof[0]
                                      if "dia_sweep_kernel" in kk) / 20)
    nbytes = outer.data.numel() * outer.data.element_size() + 4 * n * 2
    flops = 2 * outer.data.numel()
    bms, by = bound_ms(nbytes, flops)
    bms_pad, by_pad = bound_ms(nbytes + 4 * 2 * pad, flops)
    csr_host = outer.to_host()

    def make_library_call():
        M = csr_of(csr_host, dev)
        return lambda: M @ x
    lib = library_ms(make_library_call, reps, dev)
    say(f"[13 K7 dia_spmv_pallas] K1 on the unpadded x (dia_sweep_kernel; "
        f"one dia_spmv and no dia_spmv_pad launch per call in each of "
        f"{len(cases)} cases): rel err {errs} "
        f"max_abs_err {abs_err:.3e} | outer n={n}, {len(outer.offsets)} "
        f"offsets: {ms:.5f} ms per call, device time {dev_us} per launch "
        f"(the padded-x launch on a buffer padded once {ms_pad:.5f} ms) "
        f"plain {plain_ms:.5f} ms csr-library {lib} "
        f"ms | bound {bms:.5f} ms ({by}, {nbytes} B) -> {bms / ms:.3f} of "
        f"bound")
    # no route of either package calls dia_spmv_pallas, so no main path
    # launches it; the launch check above (one dia_spmv, no dia_spmv_pad
    # per call) is its evidence.  Its kernel is K1's dia_sweep_kernel,
    # whose main-path launches are row dia_spmv's.
    row = dict(name="dia_spmv_pallas", route="cuda",
               source="tpuamg_torch/csrc/dia.cu",
               replaces="tpuamg/sparse/pallas_kernels.py:37",
               launches=0, max_abs_err=abs_err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=lib)
    pad_row = dict(name="dia_spmv_pad", route="cuda",
                   source="tpuamg_torch/csrc/dia.cu",
                   replaces="tpuamg/sparse/dia_pallas.py:198", launches=0,
                   max_abs_err=abs_err, ms=ms_pad, plain_ms=plain_ms,
                   bound_ms=bms_pad, bound_by=by_pad, library_ms=lib)
    kern.extend([row, pad_row])
    return pad_row


def phase14(dev, prob, A, b, dims, mesh, k6, k_pad):
    """The slice at full width: distributed_grid_solve at n=512 with the
    kernels and with pallas=False."""
    from tpuamg_torch import kernels
    from tpuamg_torch.dist import distributed_grid_solve
    from tpuamg_torch.krylov import pcg
    on_card = dev.type == "cuda"
    out = {}
    for pallas in (None, False):
        kernels.reset_launches()
        t0 = time.perf_counter()
        res, _ = distributed_grid_solve(A, b, dims, F=2, mesh=mesh,
                                        tol=1e-8, maxiter=500, pallas=pallas)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        tr = float(np.linalg.norm(b - A.matvec(res.x)) / np.linalg.norm(b))
        out[pallas] = res
        info = res.dist_info
        say(f"[14 distributed pallas={pallas}] n={dims[0] - 1} 1 rank: "
            f"iterations {res.niters} converged {res.converged} true rel "
            f"residual {tr:.3e} | set-up + solve {wall:.2f} s | {info} | "
            f"launches {counts}")
        check(res.converged and np.isfinite(tr) and tr <= 1e-6,
              f"distributed pallas={pallas}: converged {res.converged}, "
              f"true rel residual {tr:.3e}")
        if pallas is None:
            check(info["pallas_levels"] == info["sharded_levels"]
                  and info["outer_pallas"], f"kernel coverage {info}")
            if on_card:
                for kname in ("cheb_step", "dia_spmv_pad",
                              "dia_residual_pad"):
                    check(counts.get(kname, 0) > 0,
                          f"distributed solve: kernel {kname} not launched")
                k6["launches"] = counts["cheb_step"]
                k_pad["launches"] = counts["dia_spmv_pad"]
                # one outer SpMV per executed iteration, and one for r0
                ran = counts["dia_spmv_pad"] - 1
                say(f"[14 launches] per executed iteration ({ran}): "
                    + ", ".join(f"{kk} {v / ran:.2f}" for kk, v in
                                sorted(counts.items())))
        elif on_card:
            check(not any(counts.values()),
                  f"pallas=False launched kernels {counts}")
    check(abs(out[None].niters - out[False].niters) <= 2,
          f"distributed kernels {out[None].niters} vs plain "
          f"{out[False].niters} iterations")
    # time per executed iteration and the device's idle share, on the
    # kernels' hierarchy built in phase 12
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = prob.solve(tol=1e-8, maxiter=500)
    sync(dev)
    t_solve = time.perf_counter() - t0
    ran = max(res.executed, 1)
    check_executed("distributed", res.niters, res.executed)
    say(f"[14 solve] iterations {res.niters} (executed {res.executed} in "
        f"{res.host_reads - 1} chunks) {t_solve:.3f} s: "
        f"{t_solve / ran * 1e3:.3f} ms per "
        f"executed iteration, {t_solve / max(res.niters, 1) * 1e3:.3f} per "
        f"counted")
    if on_card:
        prof = profile_busy(lambda: pcg(prob.A, prob.b, M=prob.prec.matvec,
                                        tol=0.0, maxiter=4, chunk=4), dev)
        if prof is None:
            say("[14 profile] not measured: the profiler saw no device time")
        else:
            rows_prof, busy, wall = prof
            per_it = busy / 5        # 4 iterations + the start's cycle
            say(f"[14 profile] 4 iterations: device busy {busy:.1f} us "
                f"({per_it:.1f} us per iteration, the start counted as one) "
                f"of {wall * 1e6:.1f} us wall with the profiler on; idle "
                f"share without it {1 - per_it * ran / (t_solve * 1e6):.4f}")
            say("[14 profile] device us by kernel (calls, total): "
                + json.dumps([(kk, c, round(u, 1))
                              for kk, c, u in rows_prof[:14]]))


def phase15(dev, mesh):
    """The JAX record at n=64 on one rank."""
    from tpuamg_torch.dist import distributed_grid_solve
    n = DIST_RECORD["n"]
    A, b = system(GAMMA, n)
    t0 = time.perf_counter()
    res, _ = distributed_grid_solve(A, b, (n + 1,) * 2, F=2, mesh=mesh,
                                    tol=1e-8, maxiter=120)
    sync(dev)
    info = res.dist_info
    say(f"[15 record] n={n}: iterations {res.niters} nflat {info['nflat']} "
        f"pallas_levels {info['pallas_levels']} sharded_levels "
        f"{info['sharded_levels']} outer_pallas {info['outer_pallas']} "
        f"(JAX record: {DIST_RECORD}) | {time.perf_counter() - t0:.2f} s")
    check(res.niters == DIST_RECORD["iterations"]
          and info["nflat"] == DIST_RECORD["nflat"]
          and info["pallas_levels"] == info["sharded_levels"]
          == DIST_RECORD["pallas_levels"], f"n={n} vs the JAX record")


def algebraic_slice(dev, A, b, n, n_small, alg_nrefs):
    """Phases 16-19 (module docstring)."""
    prec = phase16(dev, A, b, n)
    phase17(dev, prec)
    del prec
    phase18(dev, n_small)
    run_algebraic_driver(dev, alg_nrefs)


def phase16(dev, A, b, n):
    """solve_system(A, b, "metric_mono", ...) at full width with the
    driver's preset, float64; returns the preconditioner it built."""
    from tpuamg_torch import native
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.krylov import pcg
    from tpuamg_torch.problems import solve as tsolve
    from tpuamg_torch.sparse.device import ELL
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "the native amgkit library is not "
          "loaded")
    say(f"[16 native] amgkit {native.BUILD_INFO} "
        f"({time.perf_counter() - t0:.2f} s)")
    sizes = (A.shape[0] // 2,) * 2
    idofs = np.arange(sizes[0], A.shape[0])
    # solve_system's own call of make_preconditioner, recorded, so that
    # the phases below run the hierarchy the solve ran
    built, make = [], tsolve.make_preconditioner

    def recording(*args, **kw):
        built.append(make(*args, **kw))
        return built[-1]
    tsolve.make_preconditioner = recording
    try:
        rep = tsolve.solve_system(A, b, "metric_mono", sizes, idofs=idofs,
                                  params=PRESETS["metric_schwarz"],
                                  tol=1e-8, maxiter=500,
                                  dtype=torch.float64, device=dev)
    finally:
        tsolve.make_preconditioner = make
    prec = built[0].__self__
    true_rel = float(np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b))
    ref = ALG_ITERS_1E6.get(A.shape[0])
    # pcg stops at the crossing iterate; the card runs one more cycle for
    # the start, and a chunk that ran past the crossing runs again
    executed = rep.executed
    check_executed(f"metric_mono at n={n}", rep.niters, executed)
    ms_it = rep.t_solve / max(rep.niters, 1) * 1e3
    ms_ex = rep.t_solve / (executed + 1) * 1e3
    levels = [(L.A.shape[0], L.A.row_width, type(L.smoother).__name__)
              for L in prec.levels]
    say(f"[16 algebraic] n={n} dofs={A.shape[0]} metric_mono "
        f"(metric_schwarz: HEM x2, W-cycle, SGS, interface Schwarz), f64: "
        f"iterations {rep.niters} (JAX table: {ref}) converged "
        f"{rep.converged} cond {rep.cond:.4f} true rel residual "
        f"{true_rel:.3e} | set-up {rep.t_setup:.2f} s, solve "
        f"{rep.t_solve:.3f} s, {ms_it:.2f} ms per counted PCG iteration, "
        f"{ms_ex:.2f} ms per executed one ({executed} executed) | levels "
        f"(rows, ELL width, smoother) {levels}, coarse "
        f"{tuple(prec.coarse_inv.shape)}")
    check(rep.converged and np.isfinite(true_rel) and true_rel < 1e-4,
          f"metric_mono at n={n}: converged {rep.converged}, true rel "
          f"residual {true_rel:.3e}")
    check(ref is None or abs(rep.niters - ref) <= 1,
          f"metric_mono at n={n}: {rep.niters} iterations vs the JAX "
          f"table's {ref}")
    check(rep.cond <= 3.0, f"metric_mono at n={n}: cond {rep.cond:.3f} > 3")
    if dev.type != "cuda":
        return prec
    r = torch.as_tensor(np.random.default_rng(16).standard_normal(
        A.shape[0])).to(dev)
    prof = profile_busy(lambda: prec.matvec(r), dev)
    Aop = ELL.from_host(A, dtype=torch.float64, device=dev)
    bk = torch.as_tensor(b, dtype=torch.float64).to(dev)
    prof_it = profile_busy(lambda: pcg(Aop, bk, M=prec, tol=0.0, maxiter=2,
                                       chunk=2), dev)
    if prof is None or prof_it is None:
        say("[16 profile] not measured: the profiler saw no device time")
        return prec
    rows, busy, wall = prof
    launches = sum(c for _, c, _ in rows)
    kern_only = sum(c for k, c, _ in rows if not k.startswith("Memcpy")
                    and not k.startswith("Memset"))
    per_it = prof_it[1] / 3     # 2 iterations + the start, counted as one
    say(f"[16 profile] one cycle: {launches} device operations "
        f"({kern_only} kernels), device busy {busy:.1f} us of "
        f"{wall * 1e3:.2f} ms wall with the profiler on | PCG: device busy "
        f"{per_it:.1f} us per iteration, {ms_ex:.2f} ms per executed "
        f"iteration without the profiler: idle share "
        f"{1 - per_it / (ms_ex * 1e3):.4f}"
        f" | device us by kernel (calls, total): "
        + json.dumps([(k, c, round(u, 1)) for k, c, u in rows[:8]]))
    return prec


def phase17(dev, prec):
    """The preconditioner, the ELL matvec and one GS and one Schwarz
    sweep on the card against the same hierarchy on the CPU (f64)."""
    rng = np.random.default_rng(17)
    cpu = prec.to("cpu")
    L, Lc = prec.levels[0], cpu.levels[0]
    n = L.A.shape[0]
    x, bb = (torch.as_tensor(rng.standard_normal(n)) for _ in range(2))
    xd, bd = x.to(dev), bb.to(dev)
    sm, smc = L.smoother, Lc.smoother
    check(type(sm).__name__ == "MetricSmoother" and sm.gs is not None,
          f"level 0 smoother is {type(sm).__name__}")
    cases = {
        "cycle": (lambda: prec.matvec(xd), lambda: cpu.matvec(x)),
        "ELL matvec": (lambda: L.A.matvec(xd), lambda: Lc.A.matvec(x)),
        "GS sweep": (lambda: sm.gs.smooth(L.A, xd, bd),
                     lambda: smc.gs.smooth(Lc.A, x, bb)),
        "Schwarz sweep": (lambda: sm.schwarz.smooth(L.A, xd, bd),
                          lambda: smc.schwarz.smooth(Lc.A, x, bb)),
    }
    out = {}
    for label, (on_dev, on_cpu) in cases.items():
        got = on_dev().cpu()
        ref = on_cpu()
        err = rel_err(got, ref)
        t_dev = timed_ms(on_dev, 3 if label == "cycle" else 20, dev, 1)
        t_cpu = timed_ms(on_cpu, 1, torch.device("cpu"), 0)
        out[label] = err
        say(f"[17 parity] {label} at n={n}: rel diff card vs CPU {err:.3e} "
            f"| card {t_dev:.4f} ms, CPU {t_cpu:.4f} ms")
    check(all(np.isfinite(e) and e <= 1e-12 for e in out.values()),
          f"card vs CPU (f64): {out} > 1e-12")


def phase18(dev, n):
    """The other -precond modes and MINRES/GMRES at n (default 64)."""
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.problems.solve import solve_system
    from tpuamg_torch.sparse.host import extract_diag_blocks
    A, b = system(GAMMA, n)
    sizes = (A.shape[0] // 2,) * 2
    idofs = np.arange(sizes[0], A.shape[0])
    small = A.shape[0] == 8450         # the tables' n=64 row
    for mode, method in (("hazmath", "cg"), ("hazmath_Schwarz", "cg"),
                         ("hazmath_HEM", "cg"), ("metric", "cg"),
                         ("metric_hazmath", "cg"), ("diag", "cg"),
                         ("metric_mono", "minres"),
                         ("metric_mono", "gmres")):
        params = PRESETS["metric_schwarz"] if mode in (
            "metric", "metric_mono", "metric_hazmath") else None
        blocks = extract_diag_blocks(A, sizes) if mode == "diag" else None
        # diag (exact blocks, not gamma-robust) takes 558 iterations here
        rep = solve_system(A, b, mode, sizes, idofs=idofs, params=params,
                           blocks=blocks, tol=1e-8, method=method,
                           maxiter=2000 if mode == "diag" else 500,
                           dtype=torch.float64, device=dev)
        true_rel = float(np.linalg.norm(b - A.matvec(rep.x))
                         / np.linalg.norm(b))
        ref = ALG_ITERS_N64.get(mode) if small else None
        say(f"[18 {mode} {method}] n={n}: iterations {rep.niters} "
            f"(committed table, CG: {ref}) converged {rep.converged} cond "
            f"{rep.cond:.4f} true rel residual {true_rel:.3e} | set-up "
            f"{rep.t_setup:.2f} s, solve {rep.t_solve:.3f} s")
        check(rep.converged and true_rel < 1e-3,
              f"{mode} {method} at n={n} did not converge")
        if mode in ("hazmath_HEM", "metric", "metric_hazmath") and small:
            check(abs(rep.niters - ref) <= 1,
                  f"{mode} at n={n}: {rep.niters} iterations vs {ref}")


def run_algebraic_driver(dev, nrefs):
    """Phase 19: the bidomain_2d driver with its default -backend
    algebraic, in-process in a temporary working directory."""
    import os
    import tempfile
    from tpuamg_torch.problems.bidomain_2d import PRECONDS, run
    from tpuamg_torch.problems.driver import standard_parser
    argv = ["-precond", "metric_mono", "-nrefs", str(nrefs), "-gamma",
            "1e8"]
    args = standard_parser("hazmath", PRECONDS).parse_args(argv)
    check(args.backend == "algebraic" and args.dtype == "float64",
          f"driver defaults {args.backend} {args.dtype}")
    here = os.getcwd()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            tables = run(args, device=dev)
        finally:
            os.chdir(here)
    its = [int(row[1]) for row in tables.table_ksp]
    say(f"[19 driver] python -m tpuamg_torch.problems.bidomain_2d "
        f"{' '.join(argv)}: {time.perf_counter() - t0:.1f} s | iterations "
        f"{its} (JAX table: {list(ALG_ITERS_1E8[:nrefs])})")
    say("[19 driver] ksp rows " + json.dumps(
        [[float(v) for v in row] for row in tables.table_ksp]))
    say("[19 driver] error rows " + json.dumps(
        [[float(v) for v in row] for row in tables.table_error]))
    for got, ref in zip(its, ALG_ITERS_1E8):
        check(abs(got - ref) <= 1, f"driver iterations {its} vs "
              f"{ALG_ITERS_1E8}")
    for row in tables.table_error[1:]:
        check(0.9 <= row[3] <= 1.1 and 0.9 <= row[5] <= 1.1,
              f"driver H1 rates {row[3]:.3f}, {row[5]:.3f} outside "
              f"[0.9, 1.1]")


class recorded:
    """Within the block, module.name is recorded: .out holds what each
    call returned (the hierarchy or operator a solve built)."""

    def __init__(self, module, name):
        self.module, self.name, self.out = module, name, []

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def recording(*args, **kw):
            self.out.append(self.fn(*args, **kw))
            return self.out[-1]
        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase20(dev, mesh_n, gamma):
    """The 3D-1D pipeline at one gamma through its entry points, in a
    temporary directory, on the algebraic route (-route algebraic: with
    coords.npy on the card run_solver_3d1d takes the structured route,
    phase 21) (module docstring)."""
    import os
    import shutil
    import tempfile
    from tpuamg_torch.io_utils import load_system, read_solution
    from tpuamg_torch.problems import emi_3d1d, run_solver_3d1d
    from tpuamg_torch.problems import solve as tsolve
    with tempfile.TemporaryDirectory() as tmp:
        d, o, oc = (os.path.join(tmp, k) + "/"
                    for k in ("dump", "out", "out_cpu"))
        t0 = time.perf_counter()
        check(emi_3d1d.main(["-gamma", gamma, "-radius", "0.2", "-dump",
                             "1", "-outdir", d, "-mesh_n", str(mesh_n)])
              == 0, "emi_3d1d -dump 1 failed")
        t_dump = time.perf_counter() - t0
        with recorded(tsolve, "make_preconditioner") as rec:
            t0 = time.perf_counter()
            rep = run_solver_3d1d.main(["-indir", d, "-outdir", o,
                                        "-route", "algebraic"], device=dev)
            t_run = time.perf_counter() - t0
        prec = rec.out[0].__self__
        ref = run_solver_3d1d.main(["-indir", d, "-outdir", oc, "-route",
                                    "algebraic"], device="cpu")
        A, b, _, _ = load_system(d)
        x = read_solution(o)
        true_rel = float(np.linalg.norm(b - A.matvec(x))
                         / np.linalg.norm(b))
        err = float(np.abs(rep.x - ref.x).max() / np.abs(ref.x).max())
        shutil.copy(os.path.join(o, "solution.txt"), d)
        check(emi_3d1d.main(["-gamma", gamma, "-radius", "0.2",
                             "-load_solution", d, "-mesh_n", str(mesh_n),
                             "-outdir", d]) == 0, "-load_solution failed")
        vtu = sorted(f for f in os.listdir(d) if f.endswith(".vtu"))
        ops = "not measured (CPU rehearsal)"
        if dev.type == "cuda":
            r = torch.as_tensor(np.random.default_rng(20).standard_normal(
                A.shape[0])).to(dev)
            prof = profile_busy(lambda: prec.matvec(r), dev)
            ops = "not measured: the profiler saw no device time" \
                if prof is None else (
                    f"{sum(c for _, c, _ in prof[0])} device operations, "
                    f"device busy {prof[1]:.1f} us")
        it = max(rep.niters, 1)
        levels = [(L.A.shape[0], type(L.smoother).__name__)
                  for L in prec.levels]
        say(f"[20 3d1d gamma {float(gamma):g}] mesh_n {mesh_n}: dofs "
            f"{A.shape[0]} nnz {A.nnz} | dump {t_dump:.2f} s, "
            f"run_solver_3d1d {t_run:.2f} s (set-up {rep.t_setup:.3f} s, "
            f"solve {rep.t_solve:.4f} s, {rep.t_solve / it * 1e3:.3f} ms per "
            f"counted iteration, {rep.t_solve / (rep.executed + 1) * 1e3:.3f}"
            f" per executed one and z0) | iterations {rep.niters} (CPU "
            f"{ref.niters}; executed {rep.executed}) converged "
            f"{rep.converged}, x vs CPU {err:.3e}, true rel residual "
            f"{true_rel:.3e} | one cycle: {ops} | levels {levels} | VTU "
            f"{vtu}")
        check(rep.converged and rep.niters == ref.niters,
              f"3d1d gamma {gamma}: card {rep.niters} vs CPU {ref.niters} "
              f"iterations, converged {rep.converged}")
        check(np.isfinite(err) and err <= X3D1D_LIMIT[gamma],
              f"3d1d gamma {gamma}: x card vs CPU {err:.3e} > "
              f"{X3D1D_LIMIT[gamma]:g}")
        check(np.isfinite(true_rel) and true_rel <= 1e-6,
              f"3d1d gamma {gamma}: true rel residual {true_rel:.3e}")
        check_executed(f"3d1d gamma {gamma}", rep.niters, rep.executed)
        check(len(vtu) == 2, f"3d1d -load_solution wrote {vtu}")


class timed_tail:
    """Within the block, HostTailHybrid.tail_apply's host seconds add up
    in .seconds (calls in .calls)."""

    def __enter__(self):
        from tpuamg_torch.amg.structured import HostTailHybrid
        self.cls, self.fn = HostTailHybrid, HostTailHybrid.tail_apply
        self.seconds, self.calls = 0.0, 0

        def tail_apply(hybrid, rc):
            t0 = time.perf_counter()
            out = self.fn(hybrid, rc)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        self.cls.tail_apply = tail_apply
        return self

    def __exit__(self, *exc):
        self.cls.tail_apply = self.fn


def phase21(dev, kern, mesh_n):
    """The ninth slice (module docstring): run_solver_3d1d's structured
    route on the card at gamma 1 and 1e8 against the CPU; K1's wide entry
    on the factored operator's AD; K3 on a structured window hierarchy."""
    ad = None
    for gamma in ("1", "100000000"):
        ad, counts = phase21_solve(dev, mesh_n, gamma)
    phase21_wide(dev, kern, ad, counts)
    phase21_k3(dev)


def phase21_solve(dev, mesh_n, gamma):
    """One gamma of phase 21; returns (AD, the solve's launch counts)."""
    import os
    import tempfile
    from tpuamg_torch import kernels
    from tpuamg_torch.amg import structured as tstruct
    from tpuamg_torch.io_utils import load_system, read_solution
    from tpuamg_torch.problems import emi_3d1d, run_solver_3d1d
    from tpuamg_torch.problems import solve as tsolve
    with tempfile.TemporaryDirectory() as tmp:
        d, o, oc = (os.path.join(tmp, k) + "/"
                    for k in ("dump", "out", "out_cpu"))
        check(emi_3d1d.main(["-gamma", gamma, "-radius", "0.2", "-dump",
                             "1", "-outdir", d, "-mesh_n", str(mesh_n)])
              == 0, "emi_3d1d -dump 1 failed")
        with recorded(tstruct, "setup_structured") as hier, \
                recorded(tsolve, "_split_metric_operator") as outer, \
                timed_tail() as tail:
            sync(dev)
            kernels.reset_launches()
            t0 = time.perf_counter()
            # the card's default route; a CPU rehearsal names it
            rep = run_solver_3d1d.main(
                ["-indir", d, "-outdir", o] + (
                    [] if dev.type == "cuda" else ["-route", "structured"]),
                device=dev)
            sync(dev)
            t_run = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        ref = run_solver_3d1d.main(["-indir", d, "-outdir", oc, "-route",
                                    "structured"], device="cpu")
        t_cpu = time.perf_counter() - t0
        A, b, _, _ = load_system(d)
        true_rel = float(np.linalg.norm(b - A.matvec(read_solution(o)))
                         / np.linalg.norm(b))
    prec, slots, nsl = hier.out[0]
    AD = outer.out[0].AD
    fine = getattr(prec, "fine", prec)
    branches = [(L.A.shape[0], type(L.A).__name__,
                 len(getattr(L.A, "dia", L.A).offsets),
                 type(L.smoother).__name__) for L in fine.levels] or \
        "none (the whole hierarchy is the host tail)"
    its = sum(rep.pass_iters)
    # one outer matvec per iteration and one per pass (r0), one wide
    # launch each when AD has more than MAX_DIAGS bands
    wide = counts.get("dia_spmv_wide", 0)
    tail_ms = tail.seconds / max(tail.calls, 1) * 1e3
    ms_it = rep.t_solve / max(its, 1) * 1e3
    say(f"[21 structured gamma {float(gamma):g}] route {rep.route}; "
        f"mesh_n {mesh_n}: {len(b)} real dofs in {nsl} slots | AD "
        f"{type(AD).__name__} {len(AD.offsets)} bands "
        f"({'wide' if len(AD.offsets) > kernels.MAX_DIAGS else '<=64'} "
        f"K1 entry) | K1 wide launches {wide} for {its} iterations + "
        f"{len(rep.pass_iters)} passes ({wide / max(its, 1):.3f} per "
        f"iteration) | window levels {branches} | run_solver_3d1d "
        f"{t_run:.2f} s "
        f"(set-up {rep.t_setup:.3f} s, solve {rep.t_solve:.3f} s, "
        f"{ms_it:.2f} ms per iteration, of which host tail "
        f"{tail_ms:.2f} ms per application, {tail.calls} applications, "
        f"{tail.seconds / max(rep.t_solve, 1e-9):.3f} of the solve) | pass "
        f"iterations {list(rep.pass_iters)} (CPU {list(ref.pass_iters)}, "
        f"{t_cpu:.2f} s) converged {rep.converged} true rel residual "
        f"{true_rel:.3e} | launches {counts}")
    check(rep.route == "structured", f"run_solver_3d1d on the card took "
          f"the {rep.route!r} route")
    check(rep.converged and np.isfinite(true_rel) and true_rel <= 1e-6,
          f"structured gamma {gamma}: converged {rep.converged}, true rel "
          f"residual {true_rel:.3e}")
    check(len(rep.pass_iters) == len(ref.pass_iters) and all(
        abs(a - c) <= 1 for a, c in zip(rep.pass_iters, ref.pass_iters)),
        f"structured gamma {gamma}: pass iterations {rep.pass_iters} vs "
        f"CPU {ref.pass_iters}")
    if dev.type == "cuda":
        name = "dia_spmv_wide" if len(AD.offsets) > kernels.MAX_DIAGS \
            else "dia_spmv"
        check(counts.get(name, 0) >= its + len(rep.pass_iters),
              f"structured gamma {gamma}: {counts.get(name, 0)} {name} "
              f"launches for {its} iterations")
        # the wide launches are the tile walk's, each operator's layout
        # built once; the planes design is not launched
        check(not counts.get("dia_spmv_wide_planes")
              and not counts.get("dia_residual_wide_planes")
              and (name != "dia_spmv_wide"
                   or 0 < counts.get("dia_tiles_build", 0) <= 4),
              f"structured gamma {gamma}: wide launches {counts}")
    return AD, counts


def wide_bound(tiles, n, rhs):
    """K1's wide entry's bound (ms, by): the nonzero values, x and y (and
    b) once; and the padded planes' bytes with the same vectors."""
    item = tiles.vals.element_size()
    vec = 4 * n * (2 + (rhs is not None))
    nbytes = tiles.nnz * item + vec
    flops = 2 * tiles.nnz + (n if rhs is not None else 0)
    bms, by = bound_ms(nbytes, flops)
    return bms, by, nbytes, tiles.planes.numel() * item + vec


def wide_times(dev, op, x, rhs, reps):
    """K1's wide entry on a KernelDIA op against the planes design and
    CSR @ (addmv for a residual) on the same inputs: events in turns
    (planes, tiles, tiles, planes), then profiler device time warm and
    cold per design.  Returns {design: (events ms list, {False: warm us,
    True: cold us})}; on the CPU the plain walk's events only."""
    from tpuamg_torch.sparse.dia_kernels import (dia_spmv_wide_planes,
                                                 offsets_tensor)
    call = (lambda: op.matvec(x)) if rhs is None else \
        (lambda: op.residual(x, rhs))
    if dev.type != "cuda":
        return {"tiles": ([timed_ms(call, reps, dev)], {})}
    offs_dev = offsets_tensor(op.offsets, dev)
    M = csr_of(op.to_host(), dev)
    calls = {
        "tiles": call,
        "planes": lambda: dia_spmv_wide_planes(op.offsets, op.planes, x,
                                               rhs, offsets_dev=offs_dev),
        "csr": (lambda: M @ x) if rhs is None else
        (lambda: torch.addmv(rhs, M, x, beta=1.0, alpha=-1.0))}
    kernel = {"tiles": "dia_tiles_kernel", "planes": "dia_wide_kernel",
              "csr": lambda k: "FillFunctor" not in k}
    ev = {k: [] for k in calls}
    for k in ("planes", "tiles", "tiles", "planes", "csr"):
        ev[k].append(timed_ms(calls[k], reps, dev))
    return {k: (ev[k], warm_cold_us(calls[k], kernel[k], dev))
            for k in calls}


def wide_text(t):
    return " | ".join(
        f"{k} {'/'.join(f'{v:.5f}' for v in ev)} ms"
        + (f", device {fmt_us(wc[False])} warm, {fmt_us(wc[True])} cold"
           if wc else "") for k, (ev, wc) in t.items())


def phase21_wide(dev, kern, AD, counts):
    """K1's wide entry on AD at its real band count: against plain and
    (on the card) bit for bit against the planes design, by events and
    profiler device time (warm and after a 128 MB write) beside the
    planes design and CSR @, and its bytes bound (nonzero values, x, y,
    b once; the padded planes as a second figure)."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (dia_spmv_plain,
                                                 dia_spmv_wide_planes)
    on_card = dev.type == "cuda"
    n = AD.shape[0]
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(dev)
    bb = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32
                         ).to(dev)
    planes, offs = AD.planes, AD.offsets
    tiles = AD.tiles()
    per_tile = (tiles.band_ptr[1:] - tiles.band_ptr[:-1]).float()
    say(f"[21 K1 wide layout] AD {len(offs)} bands, {n} rows, "
        f"{planes.numel()} plane entries, {tiles.nnz} nonzeros (fill "
        f"{tiles.nnz / planes.numel():.4f}); {tiles.rows}-row tiles, bands "
        f"per tile mean {float(per_tile.mean()):.1f} max {tiles.max_bands},"
        f" {tiles.vals.numel()} entries with padding, "
        f"uint{8 * tiles.idx_bytes} indices, {tiles.stream_bytes()} B a "
        f"walk; layout builds in the solves "
        f"{counts.get('dia_tiles_build', 0)}")
    for label, rhs in (("dia_spmv_wide", None), ("dia_residual_wide", bb)):
        before = kernels.LAUNCHES[label]
        y = (AD.matvec(x) if rhs is None else AD.residual(x, rhs)).clone()
        y_p = dia_spmv_plain(offs, planes, x, rhs)
        sync(dev)
        check(not on_card or kernels.LAUNCHES[label] == before + 1,
              f"{label} kernel not launched")
        abs_err = float((y - y_p).abs().max())
        rel = abs_err / float(y_p.abs().max())
        check(np.isfinite(rel) and rel <= 1e-5,
              f"{label} vs plain: rel err {rel:.3e} > 1e-5")
        if on_card:
            check(torch.equal(y, dia_spmv_wide_planes(offs, planes, x, rhs)),
                  f"{label}: the tile walk and the planes design differ")
        reps = 200 if on_card else 2
        t = wide_times(dev, AD, x, rhs, reps)
        ms = float(np.mean(t["tiles"][0]))
        plain_ms = timed_ms(lambda: dia_spmv_plain(offs, planes, x, rhs),
                            max(reps // 20, 2), dev)
        bms, by, nbytes, padded = wide_bound(tiles, n, rhs)
        lib = float(np.mean(t["csr"][0])) if "csr" in t else None
        warm = t["tiles"][1].get(False)
        share = "" if not isinstance(warm, float) else (
            f" -> {bms * 1e3 / warm:.3f} of bound by warm device time")
        say(f"[21 K1 {label}] AD | max_abs_err {abs_err:.3e} rel {rel:.3e}"
            f"{', = planes design bit for bit' if on_card else ''} | "
            f"{wide_text(t)} | plain {plain_ms:.5f} ms | bound "
            f"{bms * 1e3:.3f} us ({by}, {nbytes} B: nonzero values, x, y"
            f"{', b' if rhs is not None else ''}; padded planes {padded} B "
            f"= {padded / HBM_BYTES_PER_S * 1e6:.3f} us){share}")
        kern.append(dict(name=label, route="cuda",
                         source="tpuamg_torch/csrc/dia_tiles.cu",
                         replaces=("tpuamg/sparse/dia_pallas.py:198"
                                   if rhs is None else
                                   "tpuamg/sparse/dia_pallas.py:210"),
                         launches=counts.get(label, 0), max_abs_err=abs_err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib))


def phase21_k3(dev, n=127):
    """K3 on structured window levels: the bidomain 2D system on the
    structured hierarchy (structured_coords, no footprint, f32; n=127:
    128 x 128 vertices, where the Morton rank is the code, and still only
    the coarsest level has <= 64 bands); each
    level's branch (FusedChebSmoother = K3 where A and C have at most
    MAX_DIAGS bands, else DiaChebyshevSmoother over K1) and each K3
    level's application against cheb_sweep_plain at phase 7's limit."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.structured import setup_structured
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    from tpuamg_torch.sparse.dia_kernels import (FusedChebSmoother,
                                                 cheb_sweep_plain)
    p = Params(2.0, 3.0, GAMMA)
    mesh = get_mesh(n, 2)
    A, _, _, _ = get_system(mesh, mms.setup_bidomain_mms(p, 2), p)
    coords = np.concatenate([mesh.vertices, mesh.vertices])
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type="v", coarse_dof=200)
    t0 = time.perf_counter()
    prec, _, _ = setup_structured(A, coords, prm, dtype=torch.float32,
                                  device=dev)
    t_set = time.perf_counter() - t0
    rng = np.random.default_rng(22)
    rows = []
    for L in prec.levels:
        sm = L.smoother
        nA = len(L.A.offsets)
        k3 = isinstance(sm, FusedChebSmoother)
        check(k3 == (nA <= kernels.MAX_DIAGS),
              f"structured level of {nA} bands took {type(sm).__name__}")
        if not k3:
            rows.append((L.A.shape[0], nA, "K1 (DiaChebyshevSmoother)"))
            wide_level(dev, getattr(L.A, "dia", L.A), rng)
            continue
        m = L.A.shape[0]
        x = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                            device=dev) * L.mask
        b = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                            device=dev) * L.mask
        before = kernels.LAUNCHES["cheb_sweep"]
        xk, _ = sm.smooth_residual(L.A, x, b, 1)
        sync(dev)
        check(dev.type != "cuda"
              or kernels.LAUNCHES["cheb_sweep"] == before + 1,
              "structured K3 not launched")
        xp, _ = cheb_sweep_plain(sm.offsA, sm.planesA, sm.offsC, sm.planesC,
                                 x, b, sm.theta, sm.coefs, sm.degree, 1)
        x64, _ = cheb_sweep_plain(sm.offsA, sm.planesA.double(), sm.offsC,
                                  sm.planesC.double(), x.double(),
                                  b.double(), sm.theta, sm.coefs,
                                  sm.degree, 1)
        floor = rel_err(xp.double(), x64)
        err = rel_err(xk, xp)
        check(err <= max(1e-5, 2 * floor),
              f"structured K3 at {m} rows: {err:.3e} vs plain (floor "
              f"{floor:.3e})")
        reps = 200 if dev.type == "cuda" else 2
        ms = timed_ms(lambda: sm.smooth_residual(L.A, x, b, 1), reps, dev)
        plain_ms = timed_ms(lambda: cheb_sweep_plain(
            sm.offsA, sm.planesA, sm.offsC, sm.planesC, x, b, sm.theta,
            sm.coefs, sm.degree, 1, True), max(reps // 20, 2), dev)
        rows.append((m, nA, f"K3 {err:.2e}, {ms:.5f} ms (plain "
                            f"{plain_ms:.5f})"))
    say(f"[21 K3 structured] bidomain 2D n={n} on setup_structured (f32, "
        f"set-up {t_set:.2f} s): levels (rows, A bands, branch, rel err "
        f"vs plain, smooth_residual by events) {rows}")
    check(any(r[2].startswith("K3") for r in rows),
          "no structured level took K3")


def wide_level(dev, A, rng):
    """K1's wide entry on a window level's operator (a KernelDIA of more
    than MAX_DIAGS bands): matvec against plain, timed beside the planes
    design and CSR @ (wide_times), with its bound."""
    from tpuamg_torch.sparse.dia_kernels import dia_spmv_plain
    m = A.shape[0]
    x = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                        device=dev)
    y = A.matvec(x)
    y_p = dia_spmv_plain(A.offsets, A.planes, x)
    rel = float((y - y_p).abs().max() / y_p.abs().max())
    check(np.isfinite(rel) and rel <= 1e-5,
          f"wide level of {m} rows: {rel:.3e} vs plain")
    tiles = A.tiles()
    bms, _, nbytes, padded = wide_bound(tiles, m, None)
    t = wide_times(dev, A, x, None, 200 if dev.type == "cuda" else 2)
    say(f"[21 K1 wide level] {m} rows, {len(A.offsets)} bands, "
        f"{tiles.nnz} nonzeros, max {tiles.max_bands} bands a tile | rel "
        f"{rel:.3e} vs plain | {wide_text(t)} | bound {bms * 1e3:.3f} us "
        f"({nbytes} B; padded planes {padded} B)")


def route_pair(fp, bk, vc, A, b, slots, n, dev, its_a, plain, ms_a=None):
    """Route (b) on fp's hierarchy (K1 outer + one K2 launch per
    iteration) and,
    with plain=True, pcg_fused over the plain chunk; returns the plain
    chunk's iterations (or route (b)'s)."""
    from tpuamg_torch.amg.grid_fused import (fused_operator, pcg_chunk_plain,
                                             pcg_fused)
    from tpuamg_torch.krylov import pcg
    out = None
    if plain:
        run_kernel = fp.run_chunk
        fp.run_chunk = lambda *a: pcg_chunk_plain(fp, *a)
        t0 = time.perf_counter()
        ref = pcg_fused(fp, bk, tol=1e-8, maxiter=500)
        sync(dev)
        tp = time.perf_counter() - t0
        fp.run_chunk = run_kernel
        out = ref.niters
        say(f"[8 plain chunk n={n}] iterations {ref.niters} (route a "
            f"{its_a}) | {tp / max(ref.niters, 1) * 1e3:.3f} ms/iteration")
    from tpuamg_torch import kernels
    kernels.reset_launches()
    t0 = time.perf_counter()
    rb = pcg(fp.Q, bk, M=fused_operator(vc), tol=1e-8, maxiter=500)
    sync(dev)
    tb = time.perf_counter() - t0
    ran = max(kernels.LAUNCHES["vcycle"], 1)     # executed, + z0's cycle
    if dev.type == "cuda":
        check(kernels.LAUNCHES["cycle_persistent"] == ran
              and not any(kernels.LAUNCHES[kk] for kk in SEQUENCED),
              f"route (b) at n={n}: launches {dict(kernels.LAUNCHES)}")
    xb = rb.x.double().cpu().numpy()[slots]
    trb = float(np.linalg.norm(b - A.matvec(xb)) / np.linalg.norm(b))
    say(f"[8 route b n={n}] same hierarchy, launch per apply: iterations "
        f"{rb.niters} (route a {its_a}; executed {ran - 1}) true rel "
        f"residual {trb:.3e} | {tb / max(rb.niters, 1) * 1e3:.3f} ms per "
        f"counted iteration, {tb / ran * 1e3:.3f} per executed cycle"
        + (f" (route a {ms_a * 1e3:.3f} per counted iteration)" if ms_a
           else ""))
    check(rb.converged and abs(rb.niters - its_a) <= 2,
          f"route (b) {rb.niters} vs route (a) {its_a} iterations at n={n}")
    return out if plain else rb.niters


def run_driver(dev, nrefs):
    """Phase 11: the bidomain_2d driver in-process, in a temporary working
    directory (results/ lands there, not in the repository)."""
    import os
    import tempfile
    from tpuamg_torch import kernels
    from tpuamg_torch.problems.bidomain_2d import PRECONDS, run
    from tpuamg_torch.problems.driver import standard_parser
    argv = ["-backend", "grid", "-dtype", "float32", "-nrefs", str(nrefs),
            "-gamma", "1e6", "-precond", "metric_mono"]
    args = standard_parser("hazmath", PRECONDS).parse_args(argv)
    here = os.getcwd()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            tables = run(args, device=dev)
        finally:
            os.chdir(here)
    say(f"[11 driver] python -m tpuamg_torch.problems.bidomain_2d "
        f"{' '.join(argv)}: {time.perf_counter() - t0:.1f} s | launches "
        f"{dict(kernels.LAUNCHES)}")
    say("[11 driver] ksp rows " + json.dumps(
        [[float(v) for v in row] for row in tables.table_ksp]))
    say("[11 driver] error rows " + json.dumps(
        [[float(v) for v in row] for row in tables.table_error]))
    for row in tables.table_ksp:
        check(0 < row[1] < 500 and np.isfinite(row[2]),
              f"driver row {row}: not converged")
    for row in tables.table_error[1:]:
        check(0.9 <= row[3] <= 1.1 and 0.9 <= row[5] <= 1.1,
              f"driver H1 rates {row[3]:.3f}, {row[5]:.3f} outside "
              f"[0.9, 1.1]")
    if dev.type == "cuda":
        check(kernels.LAUNCHES["pcg_chunk"] > 0,
              "driver: route (a) (K5) not taken")


def chunk_work(fp, chunk):
    """(bytes of every input read once + outputs written once, flops,
    bytes the chunk streams) for `chunk` iterations of K5 with the cycle
    program inside."""
    n = fp.vc.nflat
    q = fp.Q.planes.numel() * 4
    cw = cycle_work(fp.vc)
    # inputs: Q, the cycle's planes and T, x r p z in; x r p z out
    nbytes = q + (cw["inputs"] - 4 * n * 2) + 8 * 4 * n
    flops = chunk * (2 * fp.Q.planes.numel() + 14 * n + cw["flops"])
    # rz: r, z; pq: z, p (x nd reads, mostly cached), Q, p_new, q;
    # xr: x, r, p, q read, x, r written
    stream = chunk * (q + 4 * n * 2 + 4 * n * 4 + 4 * n * 6
                      + cw["stream"]) + 8 * n
    return nbytes, flops, stream


def profile_busy(fn, dev):
    """Device time by kernel over fn(), from torch.profiler (CUPTI); None
    where the profiler records no device time.  Returns (rows [(name,
    calls, total us)] by total, busy us, wall s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    agg = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        c, us = agg.get(ev.name, (0, 0.0))
        agg[ev.name] = (c + 1, us + ev.time_range.elapsed_us())
    rows = sorted(((k[:60], c, us) for k, (c, us) in agg.items()),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    return (rows, busy, wall) if busy > 0 else None


def op_bytes(vc, op):
    """Bytes one op of the cycle program streams: its planes and vectors
    each read once (neighbouring x entries from cache), what it writes
    once."""
    from tpuamg_torch.amg import cycle_program as cp
    spec = vc.spec
    nc = spec.nc
    if op.kind == cp.COARSE_GEMV:
        nsplit = vc.program().nsplit
        return vc.T.numel() * vc.T.element_size() + 4 * nc * (1 + nsplit)
    if op.kind == cp.COARSE_REDUCE:
        return 4 * nc * (vc.program().nsplit + 1)
    lv = op.level
    n = spec.levels[lv].n
    n_next = spec.levels[lv + 1].n if lv + 1 < len(spec.levels) else nc
    a = vc.A_planes[lv].numel() * vc.A_planes[lv].element_size()
    if op.kind == cp.ZERO:
        return 4 * n
    if op.kind == cp.CHEB_STEP:
        c = vc.C_planes[lv].numel() * vc.C_planes[lv].element_size()
        if op.cold:                  # b and C in; d and x out
            return c + 12 * n
        # A, C, b, x_src (and d) in; d and x_dst out
        return a + c + 16 * n + (0 if op.first else 4 * n)
    if op.kind == cp.RESID_RESTRICT:     # A, b, x in; the coarse b out
        return a + 8 * n + 4 * n_next
    if op.kind == cp.PROLONG:            # M, x, the coarse x in; x out
        m = vc.M_planes[lv].numel() * vc.M_planes[lv].element_size()
        return m + 8 * n + 4 * n_next
    raise ValueError(op)


def cycle_work(vc):
    """{"inputs": bytes of every input read once + the output written
    once, "flops": of one cycle, "stream": bytes the one-launch cycle's
    ops stream (op_bytes), "stream_sequenced": bytes the host-sequenced
    cycle streams with its separate passes}."""
    spec = vc.spec
    inputs = 4 * vc.nflat * 2 + vc.T.numel() * vc.T.element_size()
    flops = 0
    stream = vc.T.numel() * vc.T.element_size()
    visits = 1
    for lv, S in enumerate(spec.levels):
        if spec.cycle == "w" and lv and 2 ** lv <= spec.max_w_work:
            visits *= 2
        a = vc.A_planes[lv]
        c = vc.C_planes[lv]
        m = vc.M_planes[lv]
        inputs += sum(t.numel() * t.element_size() for t in (a, c, m))
        steps = S.degree * (S.pre + S.post)
        flops += visits * (2 * a.numel() * (steps + 1)
                           + (2 * c.numel() + 3 * S.n) * steps)
        # A-passes read planes + x + b, write t; C-passes read planes + t
        # + d + x, write d + x; restrict/prolong ~3 vectors
        stream += visits * ((a.numel() * a.element_size() + 12 * S.n)
                            * (steps + 1)
                            + (c.numel() * c.element_size() + 20 * S.n)
                            * steps + m.numel() * m.element_size()
                            + 16 * S.n)
    flops += 2 * spec.nc * spec.nc
    fused = sum(op_bytes(vc, op) for op in vc.program().ops)
    return dict(inputs=inputs, flops=flops, stream=fused,
                stream_sequenced=stream)


def cycle_profile(vc, bm, ms, work):
    """Phase 4: the one-launch cycle's device time over 20 back-to-back
    cycles (profiler), its idle share against the events' time per
    cycle, and both against the cycle's bounds."""
    from tpuamg_torch.amg.grid_fused import vcycle
    prof = profile_busy(lambda: [vcycle(vc, bm) for _ in range(20)],
                        bm.device)
    if prof is None:
        say("[4 profile] not measured: the profiler saw no device time")
        return
    rows_p, busy, wall = prof
    kern_us = sum(u for k, _, u in rows_p if "cycle_persistent" in k) / 20
    b_in = work["inputs"] / HBM_BYTES_PER_S * 1e6
    b_st = work["stream"] / HBM_BYTES_PER_S * 1e6
    say(f"[4 profile] 20 cycles: device busy {busy:.1f} us of "
        f"{wall * 1e6:.1f} us wall with the profiler on; the kernel "
        f"{kern_us:.2f} us per cycle against bounds {b_in:.2f} us (inputs "
        f"once) and {b_st:.2f} us (streamed); idle share of back-to-back "
        f"cycles without the profiler {1 - kern_us / (ms * 1e3):.4f} | "
        + json.dumps([(k, c, round(u, 1)) for k, c, u in rows_p[:4]]))


def op_times(vc, bm, dev, reps=20):
    """Phase 4: single ops of the one-launch cycle on the card, each as
    its own program of `reps` copies in one launch; us per op = (time of
    the reps-op launch - time of a 1-op launch) / (reps - 1), CUDA
    events, warm L2 (the same planes op after op).  The level-0 step is
    also timed alone after a 128 MB write that evicts the 50 MB L2
    (cold), by the profiler's device time of the launch, beside the same
    launch warm."""
    from tpuamg_torch.amg import cycle_program as cp
    from tpuamg_torch.amg.grid_fused import _cycle_persistent
    prog = vc.program()
    step = next(op for op in prog.ops if op.kind == cp.CHEB_STEP
                and op.level == 0 and not op.cold and not op.first)
    coarse = [op for op in prog.ops if op.kind in (cp.COARSE_GEMV,
                                                   cp.COARSE_REDUCE)][:2]

    def table(ops, k):
        recs = [o.record() for o in ops * k]
        rec = np.array(recs, np.int32)
        rec[-1, 0] |= cp.F_NO_BARRIER << 16
        return torch.from_numpy(rec).to(dev)

    out = {}
    for label, ops in (("level-0 CHEB_STEP", [step]),
                       ("coarse GEMV + REDUCE", coarse)):
        t1 = timed_ms(lambda t=table(ops, 1): _cycle_persistent(
            vc, bm, _ops=t), 50, dev)
        tk = timed_ms(lambda t=table(ops, reps): _cycle_persistent(
            vc, bm, _ops=t), 10, dev)
        us = (tk - t1) / (reps - 1) * 1e3
        nbytes = sum(op_bytes(vc, o) for o in ops)
        bound = nbytes / HBM_BYTES_PER_S * 1e6
        out[label] = us
        say(f"[4 op] {label}: {us:.2f} us per op (warm L2; a 1-op launch "
            f"{t1 * 1e3:.2f} us) | streams {nbytes} B, bound "
            f"{bound:.2f} us -> {bound / us:.3f} of bound")
    one = table([step], 1)
    dev_us = warm_cold_us(lambda: _cycle_persistent(vc, bm, _ops=one),
                          "cycle_persistent", dev)
    say(f"[4 op] level-0 CHEB_STEP alone, device time per launch: warm "
        f"{fmt_us(dev_us[False])}, cold (after a 128 MB write) "
        f"{fmt_us(dev_us[True])}")
    return out


def fmt_us(v):
    return v if isinstance(v, str) else f"{v:.2f} us"


def warm_cold_us(launch, kernel, dev, reps=10):
    """Device time per launch (us, profiler) of the kernels whose full
    name contains `kernel` (or that `kernel`, a predicate on the name,
    accepts), {False: warm L2 (the same inputs launch after launch),
    True: cold (each launch after a 128 MB write, which evicts the 50 MB
    L2)}; "not measured" where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    keep = kernel if callable(kernel) else (lambda k: kernel in k)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    out = {}
    for cold in (False, True):
        launch()
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush.fill_(1.0)
                launch()
            sync(dev)
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA and keep(ev.name))
        out[cold] = us / reps if us > 0 else "not measured"
    return out


def profile_pcg(Aop, vc, bk, iters, dev):
    """Device time by kernel over `iters` PCG iterations, from
    torch.profiler (CUPTI); None where the profiler records no device
    time.  Returns (rows [(name, calls, total us)], busy us, wall s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpuamg_torch.krylov import pcg
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pcg(Aop, bk, M=vc, tol=0.0, maxiter=iters, chunk=iters)
        sync(dev)
        wall = time.perf_counter() - t0
    agg = {}
    for ev in prof.events():        # device-side events only: kernels,
        if ev.device_type != DeviceType.CUDA:      # memcpy, memset
            continue
        c, us = agg.get(ev.name, (0, 0.0))
        agg[ev.name] = (c + 1, us + ev.time_range.elapsed_us())
    rows = [(k[:60], c, us) for k, (c, us) in agg.items()]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    return (rows, busy, wall) if busy > 0 else None


def nvidia_smi():
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() else \
            f"nvidia-smi gave nothing (rc {p.returncode})"
    except Exception as e:
        return f"nvidia-smi failed: {e}"


def main():
    say(f"[0 watchdog] {WATCHDOG_S} s: past that the run ends with a "
        f"traceback and a nonzero exit code")
    if not torch.cuda.is_available():
        say("no CUDA device: chip_smoke.py runs only on the card")
        return 1
    kern = run()
    say(json.dumps({"kernels": kern}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
