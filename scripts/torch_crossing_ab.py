#!/usr/bin/env python3
"""Whole chunks against the crossing iterate, on one card: a checkout of
the parent commit (PCG ran whole 32-iteration chunks and returned the
iterate at the end of the crossing's chunk) against this one.

Times the two solves whose whole chunks cost the most:
  - route (a) at n=256: pcg_fused (K5) in the driver's configuration
    (metric_schwarz, W-cycle, f32, gamma 1e6, tol 1e-8), after one
    warm-up solve;
  - the algebraic metric_mono at n=512: krylov.pcg over the ELL operator
    and make_preconditioner's W-cycle (f64, gamma 1e6, tol 1e-8);
one process per tree, in the order parent, this, this, parent, and
prints per run the solve seconds, the counted iterations, the executed
ones (the preconditioner's applications less z0's; for route (a) the
result's count, which the parent's result does not carry) and the host
reads where the result carries them, then the card's name and power
limit.

    git archive PARENT | tar -x -C _archive/parent    # a listed directory
    python3 scripts/torch_crossing_ab.py _archive/parent [n_a] [n_alg]
"""
import os
import subprocess
import sys
import time
from dataclasses import replace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def system(gamma, n):
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, gamma)
    A, b, sizes, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2),
                                p)
    return A, b, sizes


def report(label, t, res, executed):
    print(f"[{label}] {t:.4f} s, iterations {res.niters} executed "
          f"{executed} host reads {getattr(res, 'host_reads', 'n/a')}, "
          f"converged {res.converged}", flush=True)


def worker(tree, n_a, n_alg):
    """Both solves with the tpuamg_torch of `tree`."""
    import numpy as np
    import torch
    from tpuamg_torch.amg.grid_fused import pcg_fused, setup_grid_fused_pcg
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.krylov import pcg
    from tpuamg_torch.problems.solve import make_preconditioner
    from tpuamg_torch.sparse.device import ELL
    dev = torch.device("cuda")

    def timed(solve):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, res
    A, b, _ = system(1e6, n_a)
    fp, slots, nflat = setup_grid_fused_pcg(
        A, (n_a + 1, n_a + 1), F=2,
        params=replace(PRESETS["metric_schwarz"], dtype="float32"),
        device=dev)
    bk = torch.zeros(nflat, dtype=torch.float32)
    bk[torch.as_tensor(slots)] = torch.as_tensor(b, dtype=torch.float32)
    bk = bk.to(dev)
    pcg_fused(fp, bk, tol=1e-8, maxiter=500)          # warm-up
    t, res = timed(lambda: pcg_fused(fp, bk, tol=1e-8, maxiter=500))
    report(f"{tree} route a n={n_a}", t, res,
           getattr(res, "executed", "n/a (whole chunks of 32)"))
    del fp, bk
    A, b, sizes = system(1e6, n_alg)
    t0 = time.perf_counter()
    M = make_preconditioner("metric_mono", A, sizes,
                            idofs=np.arange(sizes[0], A.shape[0]),
                            params=PRESETS["metric_schwarz"], device=dev)
    print(f"[{tree} algebraic n={n_alg}] set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    Aop = ELL.from_host(A, dtype=torch.float64, device=dev)
    bt = torch.as_tensor(b, dtype=torch.float64).to(dev)
    calls = [0]
    apply = M.matvec if hasattr(M, "matvec") else M

    def counted(r):
        calls[0] += 1
        return apply(r)
    t, res = timed(lambda: pcg(Aop, bt, M=counted, tol=1e-8, maxiter=500))
    report(f"{tree} algebraic n={n_alg}", t, res, calls[0] - 1)
    return 0


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        tree, n_a, n_alg = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
        sys.path.insert(0, os.getcwd())
        return worker(tree, n_a, n_alg)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch_crossing_ab.py runs only on the card")
        return 1
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    parent = os.path.abspath(sys.argv[1])
    n_a = sys.argv[2] if len(sys.argv) > 2 else "256"
    n_alg = sys.argv[3] if len(sys.argv) > 3 else "512"
    rc = 0
    for tree, cwd in (("parent", parent), ("this", HERE), ("this", HERE),
                      ("parent", parent)):
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", tree, n_a, n_alg],
                             cwd=cwd).returncode
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    print(p.stdout.strip() or f"nvidia-smi gave nothing (rc {p.returncode})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
