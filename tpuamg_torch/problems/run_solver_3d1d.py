"""Offline xd-1D solver CLI.

Counterpart of the JAX package's ``problems/run_solver_3d1d.py``, a
rebuild of reference run_solver_3d1d.py + ``haznics.
fenics_metric_solver_xd_1d``: parse a HAZmath-style ``.dat`` config, load
the dumped COO system (A.npy/b.npy/idofs.npy/idofs3d.npy, and coords.npy
plus the metric factorization where the dump has them), solve with
metric-AMG-preconditioned Krylov, write ``solution.txt``
(length-prefixed).

The route follows the JAX package's rule, with the CUDA card in the TPU's
place (``-route auto``, the default): when the dump has ``coords.npy``
and the solve runs on the card, the structured route
(``solve_system(..., structured_coords=coords)``: float32 storage,
float64 Krylov vectors, the factored outer operator from the dumped
coupling, ``refine=3``, ``inner_tol=max(tol, 2e-5)``, the tiled-or-Morton
slot order, and with a non-zero ``-algebraic_below`` the host float64
tail with multicolor GS capped at 6 colors); otherwise (no coords, or
``device="cpu"``) the algebraic route (``solve_system(A, b,
"metric_hazmath", sizes, idofs=...)`` with the .dat's parameters,
float64, no refinement).  Both take clustered interface Schwarz.
``-route algebraic`` / ``-route structured`` pick one explicitly.
``route_keywords`` builds each route's keyword set; the printed "Route:"
line names the route taken.  The solve runs on the CUDA card; from
Python, ``main(argv, device="cpu")`` runs it on the CPU.

Usage:
    python -m tpuamg_torch.problems.run_solver_3d1d -infile INPUT.dat \\
        -indir DATA_DIR -outdir OUT_DIR
"""
from __future__ import annotations

import argparse
import os
from dataclasses import replace
from pathlib import Path

import torch

from .. import kernels
from ..io_utils import (print_red, load_system, load_coupling,
                        write_solution, dat_to_amg_parameters)
from .solve import solve_system

# the port's copy of the JAX package's input_metric.dat
DEFAULT_INFILE = str(Path(__file__).with_name("input_metric.dat"))


def pick_route(route, coords, device):
    """'structured' or 'algebraic': the JAX package's rule with the card in
    the TPU's place (structured when coords exist and the solve runs on
    the card), unless route names one."""
    if route != "auto":
        return route
    on_card = kernels.resolve_device(device).type == "cuda"
    return "structured" if coords is not None and on_card else "algebraic"


def route_keywords(route, amg_params, solver_cfg, coords=None,
                   coupling=None, algebraic_below=1_000_000_000,
                   keep_idofs=0, pallas="auto"):
    """The solve_system keywords of a route (besides A, b, the precond
    name, sizes and idofs): (params, keywords).

    structured: the JAX package's accelerator configuration — float32
    storage with float64 Krylov vectors, refine=3 with inner_tol
    max(tol, 2e-5), the dumped coupling (factored outer operator), the
    "auto" slot order, algebraic_below and keep_idofs as given, the host
    tail and gs_max_colors=6 when algebraic_below is non-zero, and the
    kernels unless pallas is "off".  The TPU's chunk=1 (a watchdog
    workaround) is dropped.  algebraic: float64, no refinement."""
    params = replace(amg_params, schwarz_cluster=True)
    kw = dict(tol=solver_cfg.tolerance, maxiter=solver_cfg.maxiter,
              method=solver_cfg.method, stop_type=solver_cfg.stop_type)
    if route == "algebraic":
        return params, kw
    if route != "structured":
        raise ValueError(f"route {route!r}: 'structured' or 'algebraic'")
    if coords is None:
        raise ValueError("the structured route needs coords.npy in the "
                         "dump")
    if algebraic_below:
        params = replace(params, gs_max_colors=6)
    kw.update(dtype=torch.float32, krylov_dtype=torch.float64, refine=3,
              inner_tol=max(solver_cfg.tolerance, 2e-5),
              host_tail=bool(algebraic_below),
              pallas=None if pallas == "auto" else False,
              structured_coords=coords, coupling=coupling,
              algebraic_below=algebraic_below, keep_idofs=keep_idofs,
              structured_order="auto")
    return params, kw


def main(argv=None, device=None):
    """The CLI (module docstring); device: None = the CUDA card, "cpu" =
    the plain versions.  Returns the SolveReport."""
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-infile", type=str, default=DEFAULT_INFILE,
                        help="Solver input file")
    parser.add_argument("-indir", type=str, default="./data/emi_3d1d/",
                        help="Directory with matrices (.npy)")
    parser.add_argument("-outdir", type=str, default="./results/emi_3d1d/",
                        help="Directory to output solution")
    parser.add_argument("-route", type=str, default="auto",
                        choices=("auto", "structured", "algebraic"),
                        help="auto: structured when the dump has coords "
                        "and the solve runs on the card, else algebraic")
    parser.add_argument("-algebraic_below", type=int,
                        default=1_000_000_000,
                        help="structured route: the real-dof threshold "
                        "below which levels switch to the algebraic "
                        "metric-AMG tail, run on the host in float64.  "
                        "The default is everything (no window levels); "
                        "0 = a pure window hierarchy")
    parser.add_argument("-keep_idofs", type=int, default=0,
                        help="structured route: L > 0 keeps the interface "
                        "dofs uncoarsened (injected) through at most L "
                        "window levels (tiled slot order; use with a "
                        "finite -algebraic_below); 0 = off")
    parser.add_argument("-pallas", type=str, default="auto",
                        choices=("auto", "off"),
                        help="structured route: the kernels (K1 on the "
                        "factored operator's AD part and the window "
                        "levels, K3 on their smoothers) or, with 'off', "
                        "the plain torch ops")
    args, _ = parser.parse_known_args(argv)

    print_red("Path to solver input file: " + args.infile)
    print_red("Path to matrices directory: " + args.indir)
    print_red("Path to output directory: " + args.outdir)

    for path in (args.infile, args.indir):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    os.makedirs(args.outdir, exist_ok=True)

    amg_params, solver_cfg = dat_to_amg_parameters(args.infile)
    A, b, idofs, idofs3d, coords = load_system(args.indir, with_coords=True)
    sizes = (len(idofs3d), len(b) - len(idofs3d))
    route = pick_route(args.route, coords, device)
    coupling = load_coupling(args.indir) if route == "structured" else None
    params, kw = route_keywords(
        route, amg_params, solver_cfg, coords=coords, coupling=coupling,
        algebraic_below=args.algebraic_below, keep_idofs=args.keep_idofs,
        pallas=args.pallas)
    if route == "structured":
        print_red(
            f"Route: structured (float32 storage, float64 Krylov, refine "
            f"3, {'factored' if coupling is not None else 'entrywise'} "
            f"outer operator, "
            f"{'host float64 tail below ' + str(args.algebraic_below) if args.algebraic_below else 'no tail'}"
            f" real dofs, keep_idofs {args.keep_idofs}, kernels "
            f"{args.pallas})")
    else:
        print_red("Route: algebraic metric AMG, float64")
    rep = solve_system(A, b, "metric_hazmath", sizes, idofs=idofs,
                       params=params, device=device, **kw)
    print_red(f"niters={rep.niters} converged={rep.converged} "
              f"setup={rep.t_setup:.2f}s solve={rep.t_solve:.2f}s"
              + (f" pass_iters={list(rep.pass_iters)}"
                 if rep.pass_iters else ""))
    path = write_solution(args.outdir, rep.x)
    print_red(f"Solution written to {path}")
    return rep


if __name__ == "__main__":
    main()
