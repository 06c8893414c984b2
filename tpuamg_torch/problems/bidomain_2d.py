"""Bidomain 2D experiment driver.

Counterpart of the JAX package's ``problems/bidomain_2d.py``, a
CLI-compatible rebuild of the reference driver bidomain_2d.py:105-278:
refinement sweep ncells = 2^5 .. 2^(4+nrefs), PCG to 1e-8, iteration/cond
and H1-error tables printed and written to ./results/bidomain_2d/.

Run (on the CUDA card; from Python, ``run(args, device="cpu")`` runs the
plain versions on the CPU):

    python -m tpuamg_torch.problems.bidomain_2d -precond metric_mono \\
        -nrefs 4 -gamma 1e8

The default ``-backend algebraic`` (float64, as in the JAX driver) takes
the algebraic metric-AMG branch of ``solve_system`` for every
``-precond`` mode; ``-precond diag`` hands it the diagonal blocks
(``extract_diag_blocks``).  ``-backend grid`` takes the structured-grid
hierarchy (P1).  P2 (``-pdegree 2``) and ``-save`` (VTU output) wait for
ROADMAP Queue 1 item 11 and raise NotImplementedError.
"""
from __future__ import annotations

import numpy as np

from ..config import PRESETS
from ..fem import mms
from ..io_utils import print_red
from ..sparse.host import extract_diag_blocks
from .bidomain import Params, get_mesh, get_system, compute_errors
from .driver import standard_parser, ExperimentTables, config_tag
from .solve import solve_system

PRECONDS = ("diag", "hazmath", "hazmath_Schwarz", "hazmath_HEM",
            "metric", "metric_mono", "metric_hazmath")


def run(args, dim=2, start_exp=5, name="bidomain_2d", device=None):
    """The refinement sweep of the reference driver; returns the tables.
    device: None = the CUDA card, "cpu" = the plain versions."""
    if args.pdegree != 1:
        raise NotImplementedError("P2 (fem/pk.py) is ROADMAP Queue 1 "
                                  "item 11")
    if args.save:
        raise NotImplementedError("VTU output (io_utils/vtk.py) is "
                                  "ROADMAP Queue 1 item 11")

    params = Params(args.kappa1, args.kappa2, args.gamma)
    print_red(str(params))
    data = mms.setup_bidomain_mms(params, dim=dim)

    tables = ExperimentTables(f"./results/{name}/", config_tag(args))
    dtype = np.float64 if args.dtype == "float64" else np.float32

    for ncells in (2 ** i for i in range(start_exp, start_exp + args.nrefs)):
        mesh = get_mesh(ncells, dim)
        A, b, sizes, _ = get_system(mesh, data, params,
                                    pdegree=args.pdegree)
        idofs = np.arange(sizes[0], sizes[0] + sizes[1])
        blocks = (extract_diag_blocks(A, sizes) if args.precond == "diag"
                  else None)

        # parameter dispatch of bidomain_2d.py:194-201: metric family uses
        # parameters_metric_schwarz explicitly (maxlvl=1)
        amg_params = PRESETS["metric_schwarz"] if args.precond in (
            "metric", "metric_mono", "metric_hazmath") else None

        grid = None
        if getattr(args, "backend", "algebraic") == "grid":
            grid = ((ncells + 1,) * dim, 2)   # P1: vertex dofs, 2 fields
        rep = solve_system(A, b, args.precond, sizes, idofs=idofs,
                           params=amg_params, blocks=blocks,
                           tol=1e-8, maxiter=500, dtype=dtype, grid=grid,
                           timing_runs=getattr(args, "timing_runs", 1),
                           device=device)
        ksp_dt = rep.t_setup + rep.t_solve

        e1, e2 = compute_errors(mesh, data, rep.x, sizes,
                                pdegree=args.pdegree)
        tables.add(sum(sizes), rep.niters, rep.cond, ksp_dt, rep.r_norm,
                   mesh.hmin(), [e1, e2])
        tables.show()
    return tables


if __name__ == "__main__":
    parser = standard_parser("hazmath", PRECONDS)
    args, _ = parser.parse_known_args()
    run(args)
