#!/usr/bin/env python3
"""Drive tpuamg_torch's main path on one CUDA card and check it.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

The main path is bench.py's default workload, run by the port: the
bidomain 2D monolithic system at n=512 (526,338 dofs), the fused grid
hierarchy (preset metric_schwarz, V-cycle, Chebyshev degree 4,
coarse_dof=4096, bf16 storage of the cycle's planes, float32 compute),
and PCG with one outer DIA SpMV (kernel K1) and one whole cycle (kernel
K2's launch sequence) per iteration.

Phases, one line of numbers each:
  1. build the CUDA kernels (one nvcc call) and print -Xptxas -v;
  2. the card's name and power limit (nvidia-smi);
  3. K1 against its plain version on the outer operator (f32 planes) and
     on the level-0 bf16 planes, with times, its bound and the
     torch.sparse CSR yardstick;
  4. K2 (one whole cycle) against the plain torch cycle at n=512;
  5. the PCG solve of bench.py's protocol (gamma 1e6, tol 1e-12, maxiter
     50): iterations, reduction, s/iteration, nnz/s, launch counts;
  6. gamma 1, 1e6 and 1e8 at n=512 to tol 2e-5, f32 storage.
The second slice, solve_system's grid branch (problems/solve.py) and the
bidomain_2d driver, adds:
  7. K3 (the Chebyshev sweep, csrc/cheb.cu) against its plain version on
     level 0 of the route-(c) hierarchy at n=256, f32 storage;
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
Then a JSON line {"kernels": [...]}, the nvidia-smi line, and, last, the
result line {"ok": true, "device": {...}}.  Any failed check raises, and
the script exits nonzero; a watchdog ends it, with a traceback and a
nonzero code, if it runs past WATCHDOG_S seconds.
"""
import faulthandler
import sys

WATCHDOG_S = 600
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
# the launches of csrc/vcycle.cu that one cycle makes
K2_STEPS = ("cheb_apply", "restrict", "prolong", "coarse_gemv",
            "coarse_reduce")
# the launches of csrc/pcg.cu that one chunk makes
K5_STEPS = ("pcg_rz", "pcg_pq", "pcg_xr", "pcg_finish")
N2 = 256            # the second slice's full width: route (a)'s largest n
ROUTE_A_CHUNK = 32  # pcg_fused's chunk, which route (a) keeps
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
                out.append(re.sub(r"^_Z\w*?\d+(pcg)", r"\1", m.group(1)))
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


def run(n=N, device="cuda", coarse=COARSE, n2=N2, nrefs=4):
    """All phases; returns the kernels list.  device='cpu' rehearses the
    script's own logic with the plain versions (no kernels, no counts);
    n2 and nrefs shrink the second slice's phases for such a rehearsal."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (KernelDIA, dia_spmv,
                                                 dia_spmv_plain)
    from tpuamg_torch.amg.grid_fused import vcycle, vcycle_plain
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

    # ---- 4. K2: one whole cycle ----------------------------------------
    bm = torch.as_tensor(rng.standard_normal(nflat), dtype=torch.float32
                         ).to(dev) * vc.mask_flat
    kernels.reset_launches()
    z_k = vcycle(vc, bm).clone()
    sync(dev)
    per_cycle = dict(kernels.LAUNCHES)
    if on_card:
        for k in K2_STEPS + ("dia_residual", "vcycle"):
            check(per_cycle.get(k, 0) > 0, f"cycle did not launch {k}")
    z_p = vcycle_plain(vc, bm).clone()
    sync(dev)
    abs_err = float((z_k - z_p).abs().max())
    rel = float(torch.linalg.vector_norm(z_k - z_p)
                / torch.linalg.vector_norm(z_p))
    check(bool(torch.isfinite(z_k).all()) and rel <= 1e-4,
          f"cycle vs plain: rel err {rel:.3e} > 1e-4")
    ms = timed_ms(lambda: vcycle(vc, bm), 50 if on_card else 1, dev)
    plain_ms = timed_ms(lambda: vcycle_plain(vc, bm), 5 if on_card else 1,
                        dev)
    nbytes, flops, stream_bytes = cycle_work(vc)
    bms, by = bound_ms(nbytes, flops)
    say(f"[4 K2 vcycle] rel err {rel:.3e} max_abs_err {abs_err:.3e} | "
        f"cycle {ms:.4f} ms plain {plain_ms:.4f} ms | launches/cycle "
        f"{sum(v for k, v in per_cycle.items() if k != 'vcycle')} "
        f"{per_cycle} | bound {bms:.5f} ms ({by}; inputs once "
        f"{nbytes} B, {flops} flop); streamed per cycle {stream_bytes} B "
        f"= {stream_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms")
    kern.append(dict(name="vcycle", route="cuda",
                     source="tpuamg_torch/csrc/vcycle.cu",
                     replaces="tpuamg/amg/grid_fused.py:553",
                     launches=0, max_abs_err=abs_err, ms=ms,
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None))

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
    say(f"[5 pcg] gamma {GAMMA:g} iterations {res.niters} (TPU record: 49) "
        f"reduction {red:.3e} true rel residual {true_rel:.3e} "
        f"cond {res.cond:.3f} | {t_pcg:.4f} s, {t_pcg / it * 1e3:.4f} "
        f"ms/iteration, nnz/iteration {nnz_iter}, nnz/s "
        f"{nnz_iter * it / t_pcg:.4e} | launches {counts}")
    check(np.isfinite(red) and red <= 1e-10,
          f"pcg reduction {red:.3e} > 1e-10")
    check(np.all(np.isfinite(xs)), "pcg solution not finite")
    if on_card:
        for k in K2_STEPS + ("dia_spmv", "dia_residual", "vcycle"):
            check(counts.get(k, 0) > 0, f"kernel {k} not launched by pcg")
        for row in kern:
            row["launches"] = counts[row["name"]]
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
    return kern


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


def slice2(dev, kern, A512, b512, n512, n2, nrefs):
    """Phases 7-11 (module docstring).  A512, b512: phase 5's system."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid import grid_system, setup_grid
    from tpuamg_torch.krylov import pcg
    from tpuamg_torch.amg.cycle_program import RESID_RESTRICT
    from tpuamg_torch.amg.grid_fused import (pcg_chunk, pcg_chunk_plain,
                                             pcg_chunk_sequenced, pcg_fused,
                                             persistent_grid,
                                             setup_grid_fused_pcg)
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.problems.solve import solve_system
    from tpuamg_torch.sparse.dia_kernels import (_cheb_coefs,
                                                 cheb_sweep_plain)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    A, b = system(GAMMA, n2)
    sizes = (A.shape[0] // 2,) * 2
    grid2 = ((n2 + 1, n2 + 1), 2)
    say(f"[7 setup] n={n2} dofs={A.shape[0]} nnz={A.nnz} assembly "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 7. K3 against its plain version -------------------------------
    nl_amli = replace(PRESETS["metric_schwarz"], cycle_type="nl_amli",
                      amli_degree=2, dtype="float32")
    t0 = time.perf_counter()
    prec, gslots, nd = setup_grid(A, grid2[0], F=2, params=nl_amli,
                                  dtype=torch.float32, device=dev)
    sync(dev)
    t_set = time.perf_counter() - t0
    sm = prec.levels[0].smoother
    x = torch.as_tensor(rng.standard_normal(nd), dtype=torch.float32
                        ).to(dev)
    bb = torch.as_tensor(rng.standard_normal(nd), dtype=torch.float32
                         ).to(dev)
    theta, coefs = _cheb_coefs(sm.lmax, sm.lmin, sm.degree, sm.kind)
    before = kernels.LAUNCHES["cheb_sweep"]
    xs_k, r_k = sm.smooth_residual(None, x, bb)
    x2_k = sm.smooth(None, x, bb)
    sync(dev)
    check(not on_card or kernels.LAUNCHES["cheb_sweep"] == before + 2,
          "cheb_sweep: one launch per smoother application")
    xs_p, r_p = cheb_sweep_plain(sm.offsA, sm.planesA, sm.offsC, sm.planesC,
                                 x, bb, theta, coefs, sm.degree, 1, True)
    errs = {"smooth": rel_err(x2_k, xs_p), "smooth_residual x":
            rel_err(xs_k, xs_p), "smooth_residual r": rel_err(r_k, r_p)}
    abs_err = float(max((xs_k - xs_p).abs().max(), (r_k - r_p).abs().max()))
    check(all(np.isfinite(e) and e <= 1e-5 for e in errs.values()),
          f"K3 vs plain: rel errors {errs} > 1e-5")
    reps = 100 if on_card else 1
    ms = timed_ms(lambda: sm.smooth_residual(None, x, bb), reps, dev)
    ms_s = timed_ms(lambda: sm.smooth(None, x, bb), reps, dev)
    plain_ms = timed_ms(lambda: cheb_sweep_plain(
        sm.offsA, sm.planesA, sm.offsC, sm.planesC, x, bb, theta, coefs,
        sm.degree, 1, True), max(reps // 10, 1), dev)
    pa = sm.planesA.numel() * sm.planesA.element_size()
    pc = sm.planesC.numel() * sm.planesC.element_size()
    k = sm.degree
    nbytes = pa + pc + 4 * nd * 4            # x, b in; x, r out
    flops = (k + 1) * 2 * sm.planesA.numel() + k * (
        2 * sm.planesC.numel() + 3 * nd)
    bms, by = bound_ms(nbytes, flops)
    # the algorithm's own stream: per step an A pass (planes, x, b, t)
    # and a C pass (planes, t, d and x read and written); one more A pass
    stream = (k + 1) * (pa + 12 * nd) + k * (pc + 20 * nd)
    say(f"[7 K3 cheb_sweep] level 0 n={nd} offsets A {len(sm.offsA)} C "
        f"{len(sm.offsC)} {sm.planesA.dtype} degree {k} | rel err "
        f"{errs} max_abs_err {abs_err:.3e} | smooth_residual {ms:.5f} ms "
        f"smooth {ms_s:.5f} ms plain {plain_ms:.5f} ms | bound "
        f"{bms:.5f} ms ({by}, inputs once {nbytes} B); streamed "
        f"{stream} B = {stream / HBM_BYTES_PER_S * 1e3:.5f} ms | launches "
        f"per application: 1 call, {2 * k + 1} device launches | library: "
        f"none | hierarchy set-up {t_set:.2f} s")
    k3 = dict(name="cheb_sweep", route="cuda",
              source="tpuamg_torch/csrc/cheb.cu",
              replaces="tpuamg/sparse/dia_pallas.py:436", launches=0,
              max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
              bound_by=by, library_ms=None)
    kern.append(k3)
    del sm

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
    z0 = vc.matvec(bm)
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
              and per_seq.get("vcycle") == chunk,
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
    # pcg_fused runs whole chunks and cuts the history at the crossing:
    # the card runs more iterations than the solve counts
    chunks = -(-rep.niters // ROUTE_A_CHUNK)
    if on_card:
        check(counts.get("pcg_chunk") == chunks
              and not any(counts.get(kk) for kk in K5_STEPS)
              and counts.get("vcycle") == 1,
              f"route (a): {chunks} persistent launches, none of "
              f"{K5_STEPS}, one K2 cycle (z0) expected, got {counts}")
        k5["launches"] = counts["pcg_chunk"]
    ran = chunks * ROUTE_A_CHUNK
    it = max(rep.niters, 1)
    nnz_iter = A.nnz + vc.cycle_nnz()
    say(f"[8 route a] n={n2} solve_system: iterations {rep.niters} "
        f"(executed {ran} in {chunks} whole chunks) reduction {red:.3e} "
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
              and not any(counts5.get(kk) for kk in K5_STEPS),
              f"route (a) at n={n512}: launches {counts5}")
    ran5 = chunks5 * ROUTE_A_CHUNK
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
        say(f"[9 route c pallas={pallas}] n={n2} NL-AMLI(2): iterations "
            f"{rep_c.niters} converged {rep_c.converged} true rel residual "
            f"{trc:.3e} | setup {rep_c.t_setup:.2f} s solve "
            f"{rep_c.t_solve:.3f} s ({rep_c.t_solve / itc * 1e3:.2f} "
            f"ms/iteration) | per iteration: cheb_sweep "
            f"{counts.get('cheb_sweep', 0) / itc:.1f}, K1 dia_residual "
            f"{counts.get('dia_residual', 0) / itc:.1f}, K1 dia_spmv "
            f"{counts.get('dia_spmv', 0) / itc:.1f}")
        check(rep_c.route == "c" and rep_c.converged and trc < 1e-4,
              f"route (c) pallas={pallas}: converged {rep_c.converged}, "
              f"true rel residual {trc:.3e}")
        if on_card and pallas is None:
            for kname in ("cheb_sweep", "dia_residual", "dia_spmv"):
                check(counts.get(kname, 0) > 0,
                      f"route (c): kernel {kname} not launched")
            k3["launches"] = cheb_counts = counts["cheb_sweep"]
        if pallas is False:
            check(counts.get("cheb_sweep", 0) == 0,
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
            say(f"[9 profile] route (c), 3 iterations: device busy "
                f"{busy:.1f} us ({per_it:.1f} us per iteration, the start "
                f"counted as one) of {wall * 1e6:.1f} us wall with the "
                f"profiler on; {per_cycle:g} K3 calls per cycle, "
                f"{ran_c:g} cycles executed in the solve; idle share "
                f"without it {idle:.4f}")
            say("[9 profile] device us by kernel (calls, total): "
                + json.dumps([(kk, c, round(u, 1))
                              for kk, c, u in rows_prof[:12]]))
    del prec

    # ---- 10. refine at n=512 -------------------------------------------
    v4096 = replace(PRESETS["metric_schwarz"], dtype="float32",
                    cycle_type="v", coarse_dof=4096)
    rep_r = solve_system(A512, b512, "metric_mono",
                         (A512.shape[0] // 2,) * 2, tol=1e-8, maxiter=200,
                         grid=((n512 + 1,) * 2, 2), params=v4096,
                         dtype=np.float32, refine=4, inner_tol=2e-5,
                         device=dev)
    say(f"[10 refine] n={n512} route {rep_r.route}: true rel residual "
        f"{rep_r.r_norm:.3e} converged {rep_r.converged} pass_iters "
        f"{'+'.join(map(str, rep_r.pass_iters))} (TPU record "
        f"{'+'.join(map(str, TPU_REFINE_PASSES))}) | setup "
        f"{rep_r.t_setup:.2f} s solve {rep_r.t_solve:.3f} s")
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
    x3, r3 = cheb_sweep(oA, pA, oC, pC, x, bb, theta, coefs, k, 1, True)
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
    s_b = pA.element_size()
    nbytes = (len(oA) + len(oC)) * n * s_b + 4 * (n + 2 * h) + 16 * n
    flops = 2 * (len(oA) + len(oC)) * n + 4 * n
    bms, by = bound_ms(nbytes, flops)
    say(f"[12 K6 cheb_step] level 0 n={n} halo {h} F={F} offsets A "
        f"{len(oA)} C {len(oC)} {pA.dtype}: {nsh} shards, steps vs plain "
        f"max rel err {max(errs):.3e} max_abs_err {abs_err:.3e}; vs K3 "
        f"{vs_k3} | step {ms:.5f} ms plain {plain_ms:.5f} ms | bound "
        f"{bms:.5f} ms ({by}, {nbytes} B) -> {bms / ms:.3f} of bound | "
        f"smooth_residual (degree {k}: {k} exchanges + K6, 1 exchange + "
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
    ran = max(kernels.LAUNCHES["dia_spmv_pad"] - 1, 1) if on_card else \
        -(-res.niters // 32) * 32
    say(f"[14 solve] iterations {res.niters} (executed {ran} in whole "
        f"chunks of 32) {t_solve:.3f} s: {t_solve / ran * 1e3:.3f} ms per "
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


def route_pair(fp, bk, vc, A, b, slots, n, dev, its_a, plain, ms_a=None):
    """Route (b) on fp's hierarchy (K1 outer + K2 cycle per iteration) and,
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
    bytes the chunk streams) for `chunk` iterations of K5 + K2."""
    n = fp.vc.nflat
    q = fp.Q.planes.numel() * 4
    cin, cflops, cstream = cycle_work(fp.vc)
    # inputs: Q, the cycle's planes and T, x r p z in; x r p z out
    nbytes = q + (cin - 4 * n * 2) + 8 * 4 * n
    flops = chunk * (2 * fp.Q.planes.numel() + 14 * n + cflops)
    # rz: r, z; pq: z, p (x nd reads, mostly cached), Q, p_new, q;
    # xr: x, r, p, q read, x, r written
    stream = chunk * (q + 4 * n * 2 + 4 * n * 4 + 4 * n * 6 + cstream) \
        + 8 * n
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


def cycle_work(vc):
    """(bytes of every input read once + the output written once, flops of
    one cycle, bytes the cycle streams with its re-reads)."""
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
    return inputs, flops, stream


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
