"""Preconditioner factories and monolithic solve orchestration.

Counterpart of the JAX package's ``problems/solve.py``: ``SolveReport``,
``block_diag_precond`` and ``make_preconditioner`` (the reference's
``-precond`` modes, reference utils.py:9-127), ``solve_system`` and its
float64 defect-correction loop (``refine``).

Without a grid (and for ``-precond diag``), ``solve_system`` takes the
algebraic branch: ``make_preconditioner`` builds the mode's metric-AMG
hierarchy on the host (``amg.hierarchy.setup_amg``: HEM or VMB
aggregation, multicolor GS, interface Schwarz) or the exact block-diagonal
preconditioner, and the outer operator is the ELL matrix of A
(``matvec_op(ELL.from_host(A))``), in ``krylov_dtype`` vectors where given.
The algebraic path has no hand-written kernel: its device work is torch
ops, as the JAX package's is XLA ops.  PCG, MINRES and GMRES run on it.

The grid branch (``grid=(dims, F)``) has three routes, chosen by the JAX
package's rule (on its accelerator):

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

MINRES and GMRES run on routes (b) and (c) of the grid branch, as in the
JAX package.

The structured branch (``structured_coords``, no grid) builds the
gather-free hierarchy of ``amg.structured.setup_structured`` (slot
orders, window levels, footprint operator and smoothers, an optional
float64 algebraic tail) and solves in slot space.  The outer operator is
``structured_system``'s DIA (K1 for float32 data) or, with ``coupling``
= (gamma, Pi, Mq), the factored metric form of ``_split_metric_operator``
(AD in ``dtype`` through K1, R and R^T float64 ELL), under which the
Krylov vectors default to float64.  With ``host_tail`` (and
``algebraic_below``, method "cg") the tail runs on the host and
``krylov.cg.pcg_split`` drives the split cycle.  ``fp_solver="rank1g"``
and ``"deflate"`` are not ported (ROADMAP Queue 1 item 13) and raise
ValueError.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import kernels
from ..amg.hierarchy import as_operator, setup_amg
from ..config import AMGParameters, PRESETS
from ..krylov import gmres, minres, pcg, pcg_split
from ..sparse.device import ELL, matvec_op
from ..sparse.host import HostCSR, bmat

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
    # Krylov iterations the device ran (niters counts those up to the
    # crossing; a chunk run again to reach it counts twice)
    executed: int = 0


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"solve dtype must be float32 or float64, "
                         f"not {name}")
    return getattr(torch, name)


def _dense_inv_op(A: HostCSR, dtype, device):
    inv = torch.as_tensor(np.linalg.inv(A.toarray()), dtype=dtype
                          ).to(device)
    return lambda r: inv @ r


def block_diag_precond(blocks, dtype=torch.float64, size_limit=30000,
                       device=None):
    """Exact block-diagonal preconditioner (LU role of reference
    utils.py:9-12).

    Blocks of up to ``size_limit`` rows invert densely on the host (the
    UMFPACK stand-in); larger blocks take three VMB V-cycles (still a
    fixed linear operator, so outer CG stays valid).  device: None = the
    CUDA card, "cpu" = the plain versions."""
    dev = kernels.resolve_device(device)
    dt = _torch_dtype(dtype)
    ops = []
    offs = [0]
    for B in blocks:
        nb = B.shape[0]
        offs.append(offs[-1] + nb)
        if nb <= size_limit:
            ops.append(_dense_inv_op(B, dt, dev))
        else:
            prm = AMGParameters(aggregation_type="vmb", cycle_type="v",
                                maxit=3, dtype=_dtype_name(dt))
            ops.append(as_operator(setup_amg(B, prm, device=dev)))

    def _apply(r):
        return torch.cat([ops[i](r[offs[i]:offs[i + 1]])
                          for i in range(len(ops))])
    return _apply


def make_preconditioner(precond: str, A: HostCSR, sizes, idofs=None,
                        params: AMGParameters = None, blocks=None,
                        dtype=torch.float64, device=None):
    """Map the reference's -precond choices to AMG setups (reference
    bidomain_2d.py:155-160, 190-203); returns the preconditioner as a
    callable.  device: None = the CUDA card, "cpu" = the plain versions."""
    if precond == "diag":
        if blocks is None:
            raise ValueError("precond='diag' needs the diagonal blocks "
                             "(sparse.host.extract_diag_blocks)")
        return block_diag_precond(blocks, dtype=dtype, device=device)
    if params is None:
        # 'metric'/'metric_mono' with no explicit parameters take the
        # metricAMG defaults of reference utils.py:60-82
        # (Schwarz_maxlvl=2); the bidomain driver passes
        # parameters_metric_schwarz (reference bidomain_2d.py:201).
        # hazmath_HEM passes parameters_metric (Schwarz_levels 0) but
        # hands the interface dofs to metricAMG, whose contract is
        # "the interface_dofs has the Schwarz and the rest the GS
        # smoother" (reference utils.py:84): its preset has the Schwarz.
        params = {
            "hazmath": PRESETS["standard"],
            "hazmath_Schwarz": PRESETS["standard_schwarz"],
            "hazmath_HEM": PRESETS["metric_schwarz"],
            "metric": PRESETS["metric_mono_default"],
            "metric_mono": PRESETS["metric_mono_default"],
            "metric_hazmath": PRESETS["metric_mono_default"],
        }[precond]
    wanted = _dtype_name(_torch_dtype(dtype))
    if params.dtype != wanted:
        params = replace(params, dtype=wanted)
    # plain 'hazmath' uses no interface information (reference
    # utils.py:15-42); the Schwarz/metric family takes idofs (:84-88)
    if precond == "hazmath":
        idofs = None
    return as_operator(setup_amg(A, params, idofs=idofs, device=device))


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


class SplitMetricOperator:
    """The outer operator in factored metric form,
    A x = AD x + gamma R^T Mq (R x),  R = [-Pi, I]  (slot space).

    Entrywise storage of A at large gamma cancels catastrophically: the
    metric rows' products are ~1e5x smaller than their gamma-scaled terms,
    so f32-stored entries give O(40%) relative error at gamma 1e8.  In
    factored form every factor is O(1)-conditioned and the cancellation
    R x = x1 - Pi x3 happens between float64 Krylov-vector entries.
    AD (gamma-free, narrow) is stored in ``dtype`` and fed x cast to its
    dtype (a K1 operator for float32); R and R^T are float64 ELL whatever
    ``dtype`` is (f32-rounded R leaves a fake residual that gamma
    amplifies near the gamma-null space); Mq is in ``dtype``."""

    def __init__(self, AD, R, Mq, RT, gamma):
        self.AD, self.R, self.Mq, self.RT = AD, R, Mq, RT
        self.gamma = float(gamma)
        self.shape = AD.shape

    def matvec(self, x):
        u = self.R.matvec(x)
        y = self.AD.matvec(x.to(self.AD.dtype)).to(x.dtype)
        return y + self.gamma * self.RT.matvec(self.Mq.matvec(u))


def _split_metric_operator(A, coupling, sizes, slots, nsl, dtype, pallas,
                           device):
    """SplitMetricOperator for A = AD + gamma R^T Mq R (the dumped
    coupling (gamma, Pi, Mq)), in the slot space of the structured
    hierarchy."""
    from ..amg.structured import structured_system
    g, Pi, Mq = coupling
    _, n1 = sizes
    R = bmat([[Pi.scale(-1.0), HostCSR.eye(n1)]])
    AD = A.add(R.T.matmat(Mq.matmat(R)), beta=-g)
    # prune the cancelled coupling entries (exact zeros up to f64
    # roundoff), which would widen the DIA offset set
    r_, c_, v_ = AD.to_coo()
    keep = np.abs(v_) > 1e-10 * np.abs(v_).max()
    AD = HostCSR.from_coo(r_[keep], c_[keep], v_[keep], AD.shape)
    ADop = structured_system(AD, slots, nsl, dtype=dtype, pallas=pallas,
                             device=device)
    ro, co, vo = R.to_coo()
    Rs = HostCSR.from_coo(ro, np.asarray(slots)[co], vo, (n1, nsl))
    return SplitMetricOperator(
        ADop, ELL.from_host(Rs, dtype=torch.float64, device=device),
        ELL.from_host(Mq, dtype=dtype, device=device),
        ELL.from_host(Rs.T, dtype=torch.float64, device=device), g)


def _cast_matvec(op, vec_dt):
    """op.matvec for vectors of vec_dt: K1 (a KernelDIA, alone or as a
    StructuredOp's DIA part) takes float32 x, so other vectors are cast to
    it and back; the plain classes compute in the vectors' dtype."""
    from ..sparse.dia_kernels import KernelDIA
    if isinstance(getattr(op, "dia", op), KernelDIA) \
            and vec_dt != torch.float32:
        return lambda x: op.matvec(x.to(torch.float32)).to(x.dtype)
    return op.matvec


def solve_system(A: HostCSR, b, precond: str, sizes, idofs=None,
                 params: AMGParameters = None, blocks=None,
                 tol=1e-8, maxiter=500, method="cg", stop_type=2,
                 dtype=torch.float64, callback=None,
                 grid=None, structured_coords=None, structured_order=None,
                 algebraic_below=0, fp_solver="exact", coupling=None,
                 pallas=None, refine=0, inner_tol=1e-6,
                 timing_runs=1, chunk=None, krylov_dtype=None,
                 host_tail=False, keep_idofs=0,
                 device=None) -> SolveReport:
    """Solve A x = b with a multigrid-preconditioned Krylov method.

    Without ``grid`` (and for precond="diag"): the algebraic branch,
    ``make_preconditioner`` + the ELL outer operator (module docstring);
    ``idofs`` are the interface dofs of the Schwarz/metric modes,
    ``blocks`` the diagonal blocks of "diag", and ``krylov_dtype`` the
    dtype of the Krylov vectors (default ``dtype``: f64 vectors over an
    f32 hierarchy promote every recurrence to f64).

    structured_coords: (n, d) dof coordinates — the structured branch
    (module docstring), with ``structured_order`` ("morton" by default,
    "hem", "hem_banded[:W]", "tiled", "auto"), ``algebraic_below``,
    ``fp_solver`` ("exact" or "rank1"), ``keep_idofs`` and ``host_tail``
    as in ``amg.structured.setup_structured``, and ``coupling`` =
    (gamma, Pi, Mq) for the factored outer operator.  ``idofs`` are the
    interface dofs there too.  The route is "structured".

    grid: (dims, F) — the structured-grid hierarchy, routes (a)-(c) in
    the module docstring.  The grid branch ignores ``idofs`` and
    ``blocks``, as the JAX grid branch does, and raises the JAX
    ValueError for ``krylov_dtype != dtype``.

    method: "cg", "minres" or "gmres" (GMRES restarts every 30).  The
    ``cond`` of the report is PCG's Lanczos estimate, NaN for the others.

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

    chunk: the most PCG iterations between host reads (krylov.pcg
    chunk; the fused route (a) keeps pcg_fused's own default of 32).
    PCG and MINRES return the iterate of the first iteration that meets
    the stop test (krylov.pcg, krylov.minres, pcg_fused).

    The parameters shared with the JAX signature come in its order.

    device: None = the CUDA card (an error without one); "cpu" runs the
    plain versions."""
    dev = kernels.resolve_device(device)
    dt = _torch_dtype(dtype)
    fp = None          # whole-chunk fused PCG runner (grid route (a))
    hybrid = None      # HostTailHybrid (structured branch, host_tail)
    slots = None       # the grid's dof -> slot map
    route = ""
    if structured_coords is not None and grid is None \
            and precond not in ("diag",):
        (hybrid, Aop, M, slots, nsl, t_setup, vec_dt) = _structured_branch(
            A, sizes, idofs, params, dt, method, structured_coords,
            structured_order, algebraic_below, fp_solver, coupling, pallas,
            krylov_dtype, host_tail, keep_idofs, dev)
        route = "structured"
    elif grid is not None and precond not in ("diag",):
        (fp, prec, Aop, M, slots, nsl, route, t_setup) = _grid_branch(
            A, grid, params, dt, method, pallas, krylov_dtype, dev)
        vec_dt = dt
    else:
        t0 = time.time()
        M = make_preconditioner(precond, A, sizes, idofs=idofs,
                                params=params, blocks=blocks, dtype=dt,
                                device=dev)
        _sync(dev)
        t_setup = time.time() - t0
        Aop = matvec_op(ELL.from_host(A, dtype=dt, device=dev))
        vec_dt = dt if krylov_dtype is None else _torch_dtype(krylov_dtype)

    if slots is not None:
        slots_t = torch.as_tensor(slots, device=dev)

    def _vector(v):
        v = torch.as_tensor(np.asarray(v), dtype=vec_dt).to(dev)
        if slots is None:
            return v
        out = torch.zeros(nsl, dtype=vec_dt, device=dev)
        out[slots_t] = v
        return out

    bj = _vector(b)
    t0 = time.time()

    def _run(bdev, ktol, miter):
        if fp is not None:
            from ..amg.grid_fused import pcg_fused
            r = pcg_fused(fp, bdev, tol=ktol, maxiter=miter,
                          callback=callback, stop_type=stop_type)
        elif method == "cg" and hybrid is not None:
            r = pcg_split(Aop, bdev, hybrid.fine, hybrid.tail_apply,
                          tol=ktol, maxiter=miter, callback=callback,
                          stop_type=stop_type)
        elif method == "cg":
            r = pcg(Aop, bdev, M=M, tol=ktol, maxiter=miter,
                    callback=callback, stop_type=stop_type,
                    **({"chunk": chunk} if chunk else {}))
        elif method == "minres":
            r = minres(Aop, bdev, M=M, tol=ktol, maxiter=miter)
        else:
            r = gmres(Aop, bdev, M=M, tol=ktol, maxiter=miter)
        xs = r.x.double().cpu().numpy()
        if slots is not None:
            xs = xs[slots]
        return xs, r

    if refine:
        # f64 defect correction around the device-precision inner solve,
        # on the same route and the same hierarchy
        b64 = np.asarray(b, dtype=np.float64)
        bnorm = np.linalg.norm(b64) or 1.0
        x = np.zeros_like(b64)
        total_iters, total_run, cond = 0, 0, float("nan")
        hist = []
        pass_iters = []
        for step in range(refine):
            r64 = b64 - A.matvec(x)
            rel = np.linalg.norm(r64) / bnorm
            hist.append(rel)
            if rel < tol:
                break
            d, res = _run(_vector(r64), inner_tol, maxiter)
            if step == 0 and method == "cg":
                cond = res.cond
            total_iters += res.niters
            total_run += getattr(res, "executed", res.niters)
            pass_iters.append(int(res.niters))
            x = x + d
        rel = np.linalg.norm(b64 - A.matvec(x)) / bnorm
        hist.append(rel)
        t_solve = time.time() - t0
        return SolveReport(
            x=x, niters=total_iters, converged=bool(rel < tol), cond=cond,
            r_norm=float(rel), t_setup=t_setup, t_solve=t_solve,
            residuals=np.asarray(hist), pass_iters=tuple(pass_iters),
            route=route, executed=total_run)

    x, res = _run(bj, tol, maxiter)
    cond = res.cond if method == "cg" else float("nan")
    t_solve = time.time() - t0
    for _ in range(int(timing_runs) - 1):
        t0 = time.time()
        _run(bj, tol, maxiter)
        t_solve = time.time() - t0
    return SolveReport(
        x=x, niters=res.niters, converged=res.converged, cond=cond,
        r_norm=float(res.residuals[-1]), t_setup=t_setup, t_solve=t_solve,
        residuals=res.residuals, route=route,
        executed=getattr(res, "executed", res.niters))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _structured_branch(A, sizes, idofs, params, dt, method, coords, order,
                       algebraic_below, fp_solver, coupling, pallas,
                       krylov_dtype, host_tail, keep_idofs, dev):
    """The structured branch's set-up: returns (hybrid, Aop, M, slots,
    nsl, t_setup, vec_dt); hybrid is the HostTailHybrid (M None) or
    None."""
    import warnings
    from ..amg.structured import (HostTailHybrid, setup_structured,
                                  structured_system)
    if fp_solver in ("rank1g", "deflate"):
        raise ValueError(
            f"fp_solver={fp_solver!r} is not ported (ROADMAP Queue 1 item "
            f"13: DiagRank1Smoother and the gamma-subspace deflation)")
    prm = params or PRESETS["metric_schwarz"]
    wanted = _dtype_name(dt)
    if prm.dtype != wanted:
        prm = replace(prm, dtype=wanted)
    # the host tail is a split V-cycle under PCG; other methods take the
    # unified tail, loudly, as in the JAX package
    use_host_tail = bool(host_tail and algebraic_below and method == "cg")
    if host_tail and algebraic_below and method != "cg":
        warnings.warn("host_tail=True requires method='cg'; using the "
                      "unified tail", stacklevel=3)
    t0 = time.time()
    prec, slots, nsl = setup_structured(
        A, coords, prm, dtype=dt, pallas=pallas, idofs=idofs,
        order=order or "morton", fp_solver=fp_solver,
        algebraic_below=algebraic_below, host_tail=use_host_tail,
        keep_idofs=keep_idofs, device=dev)
    if coupling is not None:
        Aop = _split_metric_operator(A, coupling, sizes, slots, nsl, dt,
                                     pallas, dev)
        # the factored operator's accuracy needs float64 Krylov vectors
        if krylov_dtype is None:
            krylov_dtype = torch.float64
    vec_dt = dt if krylov_dtype is None else _torch_dtype(krylov_dtype)
    if coupling is None:
        Aop = _cast_matvec(structured_system(
            A, slots, nsl, dtype=dt, pallas=pallas, idofs=idofs,
            device=dev), vec_dt)
    if isinstance(prec, HostTailHybrid):
        hybrid, M = prec, None
    else:
        hybrid, M = None, as_operator(prec)
    _sync(dev)
    return hybrid, Aop, M, slots, nsl, time.time() - t0, vec_dt


def _grid_branch(A, grid, params, dt, method, pallas, krylov_dtype, dev):
    """The grid branch's set-up: returns (fp, prec, Aop, M, slots, nsl,
    route, t_setup)."""
    from ..amg.grid import setup_grid, grid_system
    from ..amg.grid_fused import (setup_grid_fused, setup_grid_fused_pcg,
                                  grid_system_fused, fused_operator)

    # krylov_dtype is a structured-path feature: the grid path's kernels
    # take vectors of the hierarchy's dtype only
    if krylov_dtype is not None and _torch_dtype(krylov_dtype) != dt:
        raise ValueError("krylov_dtype != dtype is only supported "
                         "on the structured path")
    dims, F = grid
    prm = params or PRESETS["metric_schwarz"]
    wanted = _dtype_name(dt)
    if prm.dtype != wanted:
        prm = replace(prm, dtype=wanted)
    # the fused cycle (routes (a)/(b)): f32 V/W cycles with maxit=1
    fused_ok = (prm.cycle_type in ("v", "w") and prm.maxit == 1
                and dt == torch.float32 and pallas in (None, "fused"))
    t0 = time.time()
    prec = fp = None
    route = "c"
    if fused_ok:
        if method == "cg" and A.shape[0] <= FUSED_PCG_MAX_DOFS:
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
    _sync(dev)
    return fp, prec, Aop, M, slots, nsl, route, time.time() - t0
