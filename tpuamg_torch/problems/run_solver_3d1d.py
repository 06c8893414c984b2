"""Offline xd-1D solver CLI.

Counterpart of the JAX package's ``problems/run_solver_3d1d.py``, a
rebuild of reference run_solver_3d1d.py + ``haznics.
fenics_metric_solver_xd_1d``: parse a HAZmath-style ``.dat`` config, load
the dumped COO system (A.npy/b.npy/idofs.npy/idofs3d.npy), solve with
metric-AMG-preconditioned Krylov, write ``solution.txt``
(length-prefixed).

The port takes the JAX package's route off the TPU, the algebraic one
(``solve_system(A, b, "metric_hazmath", sizes, idofs=...)`` with the
.dat's parameters and clustered interface Schwarz, float64, no
refinement): the structured route (DIA + footprint blocks, ``-keep_idofs``,
the host tail) is ROADMAP Queue 1 item 10.  ``-algebraic_below`` and
``-pallas`` are accepted for the JAX CLI's sake and act on that route
only.  The solve runs on the CUDA card; from Python, ``main(argv,
device="cpu")`` runs it on the CPU.

Usage:
    python -m tpuamg_torch.problems.run_solver_3d1d -infile INPUT.dat \\
        -indir DATA_DIR -outdir OUT_DIR
"""
from __future__ import annotations

import argparse
import os
from dataclasses import replace
from pathlib import Path

from ..io_utils import (print_red, load_system, write_solution,
                        dat_to_amg_parameters)
from .solve import solve_system

# the port's copy of the JAX package's input_metric.dat
DEFAULT_INFILE = str(Path(__file__).with_name("input_metric.dat"))


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
    parser.add_argument("-algebraic_below", type=int,
                        default=1_000_000_000,
                        help="structured route only (ROADMAP Queue 1 item "
                        "10): the real-dof threshold below which its "
                        "levels switch to the algebraic tail.  Accepted "
                        "for CLI parity; the algebraic route ignores it")
    parser.add_argument("-keep_idofs", type=int, default=0,
                        help="structured route only (ROADMAP Queue 1 item "
                        "10): keep interface dofs uncoarsened through at "
                        "most L window levels.  L > 0 raises "
                        "NotImplementedError; 0 = off")
    parser.add_argument("-pallas", type=str, default="auto",
                        choices=("auto", "off"),
                        help="structured route only (ROADMAP Queue 1 item "
                        "10): the kernels of its factored outer matvec.  "
                        "Accepted for CLI parity; the algebraic route has "
                        "no kernel")
    args, _ = parser.parse_known_args(argv)
    if args.keep_idofs > 0:
        raise NotImplementedError(
            "-keep_idofs acts on the structured 3D-1D route "
            "(amg/structured.setup_structured), ROADMAP Queue 1 item 10")

    print_red("Path to solver input file: " + args.infile)
    print_red("Path to matrices directory: " + args.indir)
    print_red("Path to output directory: " + args.outdir)
    print_red("Route: algebraic metric AMG, float64 (the structured route "
              "is ROADMAP Queue 1 item 10)")

    for path in (args.infile, args.indir):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    os.makedirs(args.outdir, exist_ok=True)

    amg_params, solver_cfg = dat_to_amg_parameters(args.infile)
    A, b, idofs, idofs3d = load_system(args.indir)
    sizes = (len(idofs3d), len(b) - len(idofs3d))
    # Clustered footprint Schwarz: at production curve densities the
    # seed-per-interface-dof blocks overlap ~40 deep and nearly coincide;
    # merging overlapping blocks (smoothers.schwarz_setup.
    # merge_overlapping_blocks) gives far fewer blocks, seconds of set-up,
    # and converges where the per-seed layout h-degrades (the JAX
    # package's run_solver_3d1d.py, round 4).
    amg_params = replace(amg_params, schwarz_cluster=True)
    rep = solve_system(A, b, "metric_hazmath", sizes, idofs=idofs,
                       params=amg_params, tol=solver_cfg.tolerance,
                       maxiter=solver_cfg.maxiter,
                       method=solver_cfg.method,
                       stop_type=solver_cfg.stop_type, device=device)
    print_red(f"niters={rep.niters} converged={rep.converged} "
              f"setup={rep.t_setup:.2f}s solve={rep.t_solve:.2f}s")
    path = write_solution(args.outdir, rep.x)
    print_red(f"Solution written to {path}")
    return rep


if __name__ == "__main__":
    main()
