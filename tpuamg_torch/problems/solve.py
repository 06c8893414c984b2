"""Monolithic solve orchestration: the grid branch of ``solve_system``.

Counterpart of the JAX package's ``problems/solve.py``: ``SolveReport``,
``solve_system`` for structured grids (``grid=(dims, F)``), and its
float64 defect-correction loop (``refine``).  The grid branch has three
routes, chosen by the JAX package's rule (on its accelerator):

  (a) chunked fused PCG: method "cg", float32, a V/W cycle with maxit=1,
      at most ``FUSED_PCG_MAX_DOFS`` dofs -> ``setup_grid_fused_pcg`` +
      ``pcg_fused`` (kernel K5 around K2's cycle);
  (b) launch per apply: the same above that size -> ``setup_grid_fused``
      + ``grid_system_fused`` + ``krylov.pcg`` (K1 and K2);
  (c) the unfused grid hierarchy for every other cycle (amli, nl_amli,
      add, fmg), maxit != 1, float64, or pallas=True/False ->
      ``amg.grid.setup_grid`` + ``grid_system`` + ``krylov.pcg``
      (K3 and K1 for float32 data, plain torch ops for float64 data and
      with pallas=False).

``pallas``: None (the rule above), "fused" (routes (a)/(b) where the
cycle allows), True (route (c) with the kernel classes), False (route
(c), plain torch ops).  The route never depends on whether a card is
present; ``device`` (None = the CUDA card, "cpu" = the plain versions)
only decides how the chosen route runs.

The algebraic branch (``make_preconditioner``, every ``-precond`` mode
without a grid), the structured branch and MINRES/GMRES are ROADMAP
Queue 1 items 8 and 10; they raise NotImplementedError.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import kernels
from ..config import AMGParameters, PRESETS
from ..krylov import pcg
from ..sparse import HostCSR

# Above this many dofs route (a) gives way to route (b).  The number is a
# TPU measurement (docs/PERF_NOTES.md:156-168: the chunked kernel won at
# 132k dofs and lost at 526k on the TPU); the card has not confirmed it.
FUSED_PCG_MAX_DOFS = 300_000


@dataclass
class SolveReport:
    x: np.ndarray
    niters: int
    converged: bool
    cond: float
    r_norm: float
    t_setup: float
    t_solve: float
    residuals: np.ndarray
    # refine=k only: Krylov iterations of each refinement pass.  niters
    # is their SUM — compare per-PASS counts, not niters, against
    # single-solve tables (a refine=4 run at ~15 iters/pass reports 60).
    pass_iters: tuple = ()
    route: str = ""               # "a", "b" or "c": the grid route taken


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"solve dtype must be float32 or float64, "
                         f"not {name}")
    return getattr(torch, name)


def solve_system(A: HostCSR, b, precond: str, sizes, idofs=None,
                 params: AMGParameters = None, blocks=None,
                 tol=1e-8, maxiter=500, method="cg", stop_type=2,
                 dtype=torch.float64, callback=None,
                 grid=None, structured_coords=None,
                 pallas=None, refine=0, inner_tol=1e-6,
                 timing_runs=1, chunk=None, krylov_dtype=None,
                 device=None) -> SolveReport:
    """Solve A x = b with a multigrid-preconditioned Krylov method.

    grid: (dims, F) — the structured-grid hierarchy, the one branch ported
    so far (routes (a)-(c) in the module docstring).

    timing_runs: with 2+, after the first solve completes, the solve
    re-runs and ``t_solve`` reports the LAST run (the first pays the
    kernel build; iteration counts and solution come from the first).

    refine: mixed-precision iterative refinement.  refine=k allows up to
    k correction solves: the defect r = b - A@x is computed on the host
    in float64, each correction solves A d = r on the device in `dtype`
    to `inner_tol` (relative) on the same route, and x accumulates in
    float64.  `tol` is then the final *true-residual* target.  refine=0
    (default) = single solve, `tol` is the Krylov method's
    preconditioned-residual target.

    chunk: PCG iterations between host reads (krylov.pcg chunk; the
    fused route (a) keeps pcg_fused's own default of 32).

    The parameters shared with the JAX signature come in its order.  The
    grid branch ignores ``idofs`` and ``blocks``, as the JAX grid branch
    does, and raises the JAX ValueError for ``krylov_dtype != dtype``.

    device: None = the CUDA card (an error without one); "cpu" runs the
    plain versions."""
    if structured_coords is not None and grid is None:
        raise NotImplementedError(
            "the structured hierarchy (amg/structured.setup_structured) "
            "is ROADMAP Queue 1 item 10")
    if grid is None or precond in ("diag",):
        raise NotImplementedError(
            f"precond={precond!r} without a grid takes the algebraic "
            f"metric-AMG branch (make_preconditioner), ROADMAP Queue 1 "
            f"item 8")
    if method != "cg":
        raise NotImplementedError(
            f"method={method!r}: MINRES and GMRES are ROADMAP Queue 1 "
            f"item 8")
    from ..amg.grid import setup_grid, grid_system
    from ..amg.grid_fused import (setup_grid_fused, setup_grid_fused_pcg,
                                  grid_system_fused, fused_operator,
                                  pcg_fused)
    from ..amg.hierarchy import as_operator

    dev = kernels.resolve_device(device)
    dt = _torch_dtype(dtype)
    # krylov_dtype is a structured-path feature: the grid path's kernels
    # take vectors of the hierarchy's dtype only
    if krylov_dtype is not None and _torch_dtype(krylov_dtype) != dt:
        raise ValueError("krylov_dtype != dtype is only supported "
                         "on the structured path")
    del idofs, blocks
    dims, F = grid
    prm = params or PRESETS["metric_schwarz"]
    wanted = str(dt).replace("torch.", "")
    if prm.dtype != wanted:
        prm = replace(prm, dtype=wanted)
    # the fused cycle (routes (a)/(b)): f32 V/W cycles with maxit=1
    fused_ok = (prm.cycle_type in ("v", "w") and prm.maxit == 1
                and dt == torch.float32 and pallas in (None, "fused"))
    t0 = time.time()
    prec = fp = None
    route = "c"
    if fused_ok:
        if A.shape[0] <= FUSED_PCG_MAX_DOFS:
            try:
                fp, slots, nsl = setup_grid_fused_pcg(
                    A, dims, F=F, params=prm, device=dev)
                prec = fp.vc
                Aop = M = None
                route = "a"
            except ValueError:
                fp = None
        if fp is None:
            try:
                vc, slots, nsl = setup_grid_fused(A, dims, F=F, params=prm,
                                                  device=dev)
                Aop = grid_system_fused(A, slots, nsl, dtype=dt,
                                        device=dev)
                M = fused_operator(vc)
                prec = vc
                route = "b"
            except ValueError:
                prec = None
    if prec is None:
        prec, slots, nsl = setup_grid(A, dims, F=F, params=prm, dtype=dt,
                                      pallas=pallas, device=dev)
        Aop = grid_system(A, slots, dtype=dt, pallas=pallas, device=dev)
        M = as_operator(prec)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_setup = time.time() - t0
    slots_t = torch.as_tensor(slots, device=dev)

    def _scatter(v):
        out = torch.zeros(nsl, dtype=dt, device=dev)
        out[slots_t] = torch.as_tensor(np.asarray(v), dtype=dt).to(dev)
        return out

    bj = _scatter(b)
    t0 = time.time()

    def _run(bdev, ktol, miter):
        if fp is not None:
            r = pcg_fused(fp, bdev, tol=ktol, maxiter=miter,
                          callback=callback, stop_type=stop_type)
        else:
            r = pcg(Aop, bdev, M=M, tol=ktol, maxiter=miter,
                    callback=callback, stop_type=stop_type,
                    **({"chunk": chunk} if chunk else {}))
        xs = r.x.double().cpu().numpy()[slots]
        return xs, r

    if refine:
        # f64 defect correction around the device-precision inner solve,
        # on the same route and the same hierarchy
        b64 = np.asarray(b, dtype=np.float64)
        bnorm = np.linalg.norm(b64) or 1.0
        x = np.zeros_like(b64)
        total_iters, cond = 0, float("nan")
        hist = []
        pass_iters = []
        for step in range(refine):
            r64 = b64 - A.matvec(x)
            rel = np.linalg.norm(r64) / bnorm
            hist.append(rel)
            if rel < tol:
                break
            d, res = _run(_scatter(r64), inner_tol, maxiter)
            if step == 0:
                cond = res.cond
            total_iters += res.niters
            pass_iters.append(int(res.niters))
            x = x + d
        rel = np.linalg.norm(b64 - A.matvec(x)) / bnorm
        hist.append(rel)
        t_solve = time.time() - t0
        return SolveReport(
            x=x, niters=total_iters, converged=bool(rel < tol), cond=cond,
            r_norm=float(rel), t_setup=t_setup, t_solve=t_solve,
            residuals=np.asarray(hist), pass_iters=tuple(pass_iters),
            route=route)

    x, res = _run(bj, tol, maxiter)
    cond = res.cond
    t_solve = time.time() - t0
    for _ in range(int(timing_runs) - 1):
        t0 = time.time()
        _run(bj, tol, maxiter)
        t_solve = time.time() - t0
    return SolveReport(
        x=x, niters=res.niters, converged=res.converged, cond=cond,
        r_norm=float(res.residuals[-1]), t_setup=t_setup, t_solve=t_solve,
        residuals=res.residuals, route=route)
