#!/usr/bin/env python3
"""The 3D-1D pipeline of tpuamg_torch at production scale on one CUDA card.

Configuration (docs/sample_results/scale_3d1d_n64.txt:1): bulk mesh_n 64
(274,625 vertices) and the synthetic neuron -n_main 2400 -n_branches 48
-nseg 4 (2,592 curve vertices); -radius 0.05, which the script that wrote
that line passes (scripts/exp_3d1d_scale.py:48), and emi_3d1d's CLI
defaults for the rest (seed 7 of synthetic_neuron_curve);
input_metric.dat (CG, stop type 1, tol 1e-6, maxiter 1000); gamma 1 and
1e8.  Per gamma, through the entry points a user calls:

    python -m tpuamg_torch.problems.emi_3d1d -dump 1 ...   (host numpy)
    python -m tpuamg_torch.problems.run_solver_3d1d ...    (on the card)

both in-process, in a temporary directory.  It prints, per gamma: the
assembly and dump seconds, set-up seconds, iterations (counted and
executed), solve seconds, ms per iteration, the device operations of one
preconditioner application and of two PCG iterations (torch.profiler),
the device's idle share during the solve, and the true relative residual
(host, float64); then the card's name and power limit (nvidia-smi) and a
JSON line of the numbers.

The gate is convergence to a true relative residual of 1e-6 within the
.dat's maxiter at both gammas; it exits nonzero otherwise.  The JAX
package's TPU record on its structured f32 + refine route (102
iterations at gamma 1e8, 77 at gamma 1) is printed beside the count as a
reference, not a gate.

--route algebraic (the default here) solves as above (-route algebraic
of run_solver_3d1d).  --route structured takes run_solver_3d1d's
structured route, its default on the card (f32 storage, f64 Krylov
vectors, refine 3, the factored outer operator with AD on kernel K1, the
whole metric-AMG hierarchy as the host float64 tail); it prints the pass
iterations, ms per iteration split into the host tail and the rest (the
device work and its host launches), the device busy time of two PCG
iterations without the tail (torch.profiler) and the idle share.

    python3 scripts/torch_3d1d_scale.py [--route algebraic|structured]
        [mesh_n] [radius] [gamma ...]
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CURVE = ["-n_main", "2400", "-n_branches", "48", "-nseg", "4"]
GAMMAS = ("1", "100000000")
# docs/sample_results/scale_3d1d_n64.txt: the TPU's structured route
TPU_RECORD = {"1": 77, "100000000": 102}


def say(*parts):
    print(*parts, flush=True)


def nvidia_smi():
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() else \
            f"nvidia-smi gave nothing (rc {p.returncode})"
    except Exception as e:      # noqa: BLE001 - report, do not fail
        return f"nvidia-smi failed: {e}"


def device_busy(fn, dev):
    """(device operations, device busy us, [(kernel, calls, us)] by time)
    of fn() from torch.profiler; None where the profiler records no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    busy = sum(ev.time_range.elapsed_us() for ev in evs)
    agg = {}
    for ev in evs:
        c, us = agg.get(ev.name, (0, 0.0))
        agg[ev.name] = (c + 1, us + ev.time_range.elapsed_us())
    rows = sorted(((k[:70], c, round(us, 1)) for k, (c, us) in agg.items()),
                  key=lambda r: -r[2])
    return (len(evs), busy, rows) if busy > 0 else None


def run_structured(dev, d, o, gamma, t_asm):
    """run_solver_3d1d's structured route on the dump in d; the numbers."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg import structured as tstruct
    from tpuamg_torch.amg.structured import HostTailHybrid
    from tpuamg_torch.io_utils import load_system, read_solution
    from tpuamg_torch.krylov import pcg_split
    from tpuamg_torch.problems import run_solver_3d1d
    from tpuamg_torch.problems import solve as tsolve
    built, outer, tail = [], [], {"s": 0.0, "calls": 0}
    setup, split, apply = (tstruct.setup_structured,
                           tsolve._split_metric_operator,
                           HostTailHybrid.tail_apply)

    def rec_setup(*a, **k):
        built.append(setup(*a, **k))
        return built[-1]

    def rec_split(*a, **k):
        outer.append(split(*a, **k))
        return outer[-1]

    def timed_apply(hybrid, rc):
        t0 = time.perf_counter()
        out = apply(hybrid, rc)
        tail["s"] += time.perf_counter() - t0
        tail["calls"] += 1
        return out
    tstruct.setup_structured, tsolve._split_metric_operator = \
        rec_setup, rec_split
    HostTailHybrid.tail_apply = timed_apply
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        rep = run_solver_3d1d.main(["-indir", d, "-outdir", o, "-route",
                                    "structured"], device=dev)
        torch.cuda.synchronize(dev)
        t_run = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
    finally:
        tstruct.setup_structured, tsolve._split_metric_operator = \
            setup, split
        HostTailHybrid.tail_apply = apply
    prec, slots, nsl = built[0]
    AD = outer[0].AD
    A, b, _, _ = load_system(d)
    true_rel = float(np.linalg.norm(b - A.matvec(read_solution(o)))
                     / np.linalg.norm(b))
    its = sum(rep.pass_iters)
    ms_it = rep.t_solve / max(its, 1) * 1e3
    tail_ms = tail["s"] / max(tail["calls"], 1) * 1e3
    # device busy of two PCG iterations with the tail replaced by an
    # identity step (the device part of an iteration: outer operator,
    # fine levels (none here), CG updates, the boundary copies)
    bk = torch.zeros(nsl, dtype=torch.float64, device=dev)
    bk[torch.as_tensor(slots, device=dev)] = torch.as_tensor(
        b, dtype=torch.float64, device=dev)
    two = device_busy(lambda: pcg_split(outer[0], bk, prec.fine,
                                        lambda rc: rc, tol=0.0, maxiter=2),
                      dev)
    per_it = None if two is None else two[1] / 3
    idle = "not measured" if per_it is None else 1 - per_it / (ms_it * 1e3)
    out = dict(
        route="structured", gamma=float(gamma), dofs=A.shape[0], nnz=A.nnz,
        slots=int(nsl), ad_bands=len(AD.offsets),
        assembly_dump_s=t_asm, run_solver_s=t_run, setup_s=rep.t_setup,
        solve_s=rep.t_solve, pass_iterations=list(rep.pass_iters),
        iterations=its, converged=bool(rep.converged),
        ms_per_iteration=ms_it, host_tail_ms_per_application=tail_ms,
        host_tail_applications=tail["calls"],
        host_tail_share=tail["s"] / max(rep.t_solve, 1e-9),
        device_us_per_iteration=per_it, idle_share=idle,
        launches=counts, true_rel_residual=true_rel,
        tpu_record_iterations=TPU_RECORD.get(gamma),
        window_levels=len(prec.fine.levels))
    say(f"[scale structured gamma {float(gamma):g}] dofs {A.shape[0]} in "
        f"{nsl} slots, AD {len(AD.offsets)} bands | assembly + dump "
        f"{t_asm:.2f} s | set-up {rep.t_setup:.2f} s, solve "
        f"{rep.t_solve:.3f} s, pass iterations {list(rep.pass_iters)} "
        f"(TPU record {TPU_RECORD.get(gamma)} in all) converged "
        f"{rep.converged} | {ms_it:.2f} ms per iteration: host tail "
        f"{tail_ms:.2f} ms per application ({tail['calls']} applications,"
        f" {out['host_tail_share']:.4f} of the solve), device busy "
        f"{per_it} us per iteration, idle share {idle} | launches {counts}"
        f" | true rel residual {true_rel:.3e}")
    return out


def run_gamma(dev, mesh_n, radius, gamma, tmp, route="algebraic"):
    from tpuamg_torch.io_utils import load_system, read_solution
    from tpuamg_torch.krylov import pcg
    from tpuamg_torch.problems import emi_3d1d, run_solver_3d1d
    from tpuamg_torch.problems import solve as tsolve
    from tpuamg_torch.sparse.device import ELL
    d, o = (os.path.join(tmp, f"{k}_g{gamma}") + "/" for k in ("dump",
                                                                "out"))
    t0 = time.perf_counter()
    emi_3d1d.main(["-gamma", gamma, "-radius", str(radius), "-dump", "1",
                   "-outdir", d, "-mesh_n", str(mesh_n)] + CURVE)
    t_asm = time.perf_counter() - t0
    say(f"[scale gamma {float(gamma):g}] assembly + dump {t_asm:.2f} s")
    if route == "structured":
        out = run_structured(dev, d, o, gamma, t_asm)
        shutil.rmtree(d, ignore_errors=True)
        return out
    built, make = [], tsolve.make_preconditioner

    def recording(*args, **kw):
        built.append(make(*args, **kw))
        return built[-1]
    tsolve.make_preconditioner = recording
    try:
        t0 = time.perf_counter()
        rep = run_solver_3d1d.main(["-indir", d, "-outdir", o, "-route",
                                    "algebraic"], device=dev)
        t_run = time.perf_counter() - t0
    finally:
        tsolve.make_preconditioner = make
    prec = built[0].__self__
    A, b, _, _ = load_system(d)
    x = read_solution(o)
    true_rel = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
    ms_it = rep.t_solve / max(rep.niters, 1) * 1e3
    ms_ex = rep.t_solve / (rep.executed + 1) * 1e3
    r = torch.as_tensor(np.random.default_rng(64).standard_normal(
        A.shape[0])).to(dev)
    cyc = device_busy(lambda: prec.matvec(r), dev)
    Aop = ELL.from_host(A, dtype=torch.float64, device=dev)
    bk = torch.as_tensor(b, dtype=torch.float64).to(dev)
    two = device_busy(lambda: pcg(Aop, bk, M=prec, tol=0.0, maxiter=2,
                                  chunk=2), dev)
    if two is None:
        idle = "not measured"
    else:
        per_it = two[1] / 3        # 2 iterations + the start, as one
        idle = 1 - per_it / (ms_ex * 1e3)
    out = dict(
        gamma=float(gamma), mesh_n=mesh_n, radius=radius,
        dofs=A.shape[0], nnz=A.nnz,
        assembly_dump_s=t_asm, run_solver_s=t_run, setup_s=rep.t_setup,
        solve_s=rep.t_solve, iterations=rep.niters, executed=rep.executed,
        converged=bool(rep.converged), ms_per_iteration=ms_it,
        ms_per_executed=ms_ex,
        cycle_device_ops=None if cyc is None else cyc[0],
        cycle_device_us=None if cyc is None else cyc[1],
        cycle_kernels=None if cyc is None else cyc[2][:10],
        pcg2_device_ops=None if two is None else two[0],
        idle_share=idle, true_rel_residual=true_rel,
        tpu_record_iterations=TPU_RECORD.get(gamma),
        levels=[(L.A.shape[0], type(L.smoother).__name__)
                for L in prec.levels])
    say(f"[scale gamma {float(gamma):g}] mesh_n {mesh_n}: dofs {A.shape[0]} "
        f"nnz {A.nnz} | assembly + dump {t_asm:.2f} s | set-up "
        f"{rep.t_setup:.2f} s, solve {rep.t_solve:.3f} s, iterations "
        f"{rep.niters} (executed {rep.executed}; TPU record "
        f"{TPU_RECORD.get(gamma)}, structured f32 + refine) converged "
        f"{rep.converged}, {ms_it:.2f} ms per iteration | one cycle: "
        f"{out['cycle_device_ops']} device operations, "
        f"{out['cycle_device_us']} us busy | idle share {idle} | true rel "
        f"residual {true_rel:.3e} | levels {out['levels']}")
    if cyc is not None:
        say("[scale] one cycle, device us by kernel (calls, total): "
            + json.dumps(cyc[2][:10]))
    shutil.rmtree(d, ignore_errors=True)
    return out


def main():
    if not torch.cuda.is_available():
        say("no CUDA device: torch_3d1d_scale.py runs only on the card")
        return 1
    argv = sys.argv[1:]
    route = "algebraic"
    if argv[:1] == ["--route"]:
        route, argv = argv[1], argv[2:]
    if route not in ("algebraic", "structured"):
        say(f"--route {route}: algebraic or structured")
        return 2
    mesh_n = int(argv[0]) if len(argv) > 0 else 64
    radius = float(argv[1]) if len(argv) > 1 else 0.05
    gammas = tuple(argv[2:]) or GAMMAS
    dev = torch.device("cuda")
    say(nvidia_smi())
    say(f"route {route} mesh_n {mesh_n} radius {radius:g} curve "
        f"{' '.join(CURVE)} gammas {' '.join(gammas)}")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for gamma in gammas:
            rows.append(run_gamma(dev, mesh_n, radius, gamma, tmp, route))
    say(nvidia_smi())
    say(json.dumps({"torch_3d1d_scale": rows}))
    ok = all(r["converged"] and r["true_rel_residual"] <= 1e-6
             for r in rows)
    say(json.dumps({"ok": ok}))
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
