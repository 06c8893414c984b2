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
    spills = [ln.strip() for ln in log.splitlines()
              if "spill" in ln and not re.search(r"\b0 bytes spill", ln)]
    return out, spills


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


def run(n=N, device="cuda", coarse=COARSE):
    """All phases; returns the kernels list.  device='cpu' rehearses the
    script's own logic with the plain versions (no kernels, no counts)."""
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
    return kern


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
