#!/usr/bin/env python3
"""How far float64 rounding alone moves a PCG solution.

A card and the CPU run the same solve in a different summation order, so
their x differ by about what one unit of rounding moves it.  This script
measures that: it solves once as the port does, then again with every
product of A and of the preconditioner multiplied entry by entry by
1 +- 2.2e-16 (one unit of rounding, random signs), several times, and
prints the iterations and the largest relative difference in x (max
norm) from the unperturbed solve.  x is the crossing iterate (the first
iterate that meets the stop test).  The solves run on the CPU, or on the
card with ``--device cuda`` anywhere in the arguments.

    python scripts/torch_rounding_floor.py 3d1d [mesh_n] [gamma] [trials]
        the 3D-1D dump (emi_3d1d -dump 1, radius 0.2, the default
        synthetic neuron) solved as run_solver_3d1d does
        (input_metric.dat, clustered Schwarz, f64, stop type 1, tol
        1e-6); cond(A) printed up to 2,000 dofs
    python scripts/torch_rounding_floor.py bidomain [precond] [trials]
        the n=16 bidomain system (gamma 1e6) as solve_system builds it
        for a -precond mode, f64, tol 1e-8
"""
import os
import sys
import tempfile
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def system_3d1d(mesh_n, gamma, device):
    from tpuamg_torch.io_utils import dat_to_amg_parameters, load_system
    from tpuamg_torch.problems import emi_3d1d
    from tpuamg_torch.problems.run_solver_3d1d import DEFAULT_INFILE
    from tpuamg_torch.problems.solve import make_preconditioner
    with tempfile.TemporaryDirectory() as d:
        emi_3d1d.main(["-gamma", gamma, "-radius", "0.2", "-dump", "1",
                       "-outdir", d, "-mesh_n", str(mesh_n)])
        A, b, idofs, idofs3d = load_system(d)
    amg, sol = dat_to_amg_parameters(DEFAULT_INFILE)
    sizes = (len(idofs3d), len(b) - len(idofs3d))
    M = make_preconditioner("metric_hazmath", A, sizes, idofs=idofs,
                            params=replace(amg, schwarz_cluster=True),
                            device=device)
    return A, b, M, dict(tol=sol.tolerance, maxiter=sol.maxiter,
                         stop_type=sol.stop_type)


def system_bidomain(precond, device):
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    from tpuamg_torch.problems.solve import make_preconditioner
    p = Params(2.0, 3.0, 1e6)
    A, b, sizes, _ = get_system(get_mesh(16, 2), mms.setup_bidomain_mms(p, 2),
                                p)
    M = make_preconditioner(
        precond, A, sizes, idofs=np.arange(sizes[0], A.shape[0]),
        params=PRESETS["metric_schwarz"] if precond in (
            "metric", "metric_mono", "metric_hazmath") else None,
        device=device)
    return A, b, M, dict(tol=1e-8, maxiter=500)


def main():
    from tpuamg_torch.krylov import pcg
    from tpuamg_torch.sparse.device import ELL, matvec_op
    args = sys.argv[1:]
    device = "cpu"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    what = args[0] if args else "3d1d"
    if what == "3d1d":
        mesh_n = int(args[1]) if len(args) > 1 else 16
        gamma = args[2] if len(args) > 2 else "100000000"
        trials = int(args[3]) if len(args) > 3 else 5
        A, b, M, kw = system_3d1d(mesh_n, gamma, device)
        label = f"3d1d mesh_n {mesh_n} gamma {float(gamma):g}"
    else:
        precond = args[1] if len(args) > 1 else "hazmath"
        trials = int(args[2]) if len(args) > 2 else 4
        A, b, M, kw = system_bidomain(precond, device)
        label = f"bidomain n=16 gamma 1e6 {precond}"
    Aop = matvec_op(ELL.from_host(A, dtype=torch.float64, device=device))
    bt = torch.as_tensor(b).to(device)
    rng = np.random.default_rng(0)

    def noisy(fn):
        def apply(v):
            y = fn(v)
            s = torch.as_tensor(rng.choice([-1.0, 1.0], size=y.shape))
            return y * (1 + 2.2e-16 * s.to(y.device))
        return apply
    ref = pcg(Aop, bt, M=M, **kw)
    diffs = []
    for _ in range(trials):
        got = pcg(noisy(Aop), bt, M=noisy(M), **kw)
        diffs.append(float((got.x - ref.x).abs().max() / ref.x.abs().max()))
        print(f"iterations {got.niters} (unperturbed {ref.niters}) x "
              f"rel diff {diffs[-1]:.3e}", flush=True)
    print(f"{label} dofs {A.shape[0]} on {device}, crossing iterate: x "
          f"moved by {min(diffs):.3e} .. {max(diffs):.3e} over {trials} "
          f"trials of one-ulp noise", flush=True)
    if A.shape[0] <= 2000:      # a dense 2-norm condition number
        print(f"cond(A) {np.linalg.cond(A.toarray()):.3e}")


if __name__ == "__main__":
    main()
