"""The distributed grid solve of both packages, one rank, on the CPU.

Runs tpuamg.dist.solve.distributed_grid_solve (pallas=False, one virtual
device) and tpuamg_torch.dist.distributed_grid_solve (pallas=False, a
one-rank gloo group) on the same bidomain 2D system (gamma 1e6, f32,
V-cycle, tol 1e-8, the functions' defaults otherwise) and prints each
one's iterations, true relative residual and dist_info.

    JAX_PLATFORMS=cpu python scripts/torch_dist_parity.py [n]

n defaults to 512 (526,338 dofs), the size of chip_smoke.py's phase 14;
expect minutes on the CPU at that size.
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch
    from tpuamg.dist import device_mesh as jax_mesh
    from tpuamg.dist.solve import distributed_grid_solve as jax_solve
    from tpuamg_torch.dist import device_mesh, distributed_grid_solve
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, 1e6)
    A, b, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    from tpuamg.sparse import HostCSR
    runs = (
        ("jax", lambda: jax_solve(
            HostCSR(A.indptr, A.indices, A.data, A.shape), b,
            (n + 1, n + 1), F=2, tol=1e-8, maxiter=500, pallas=False,
            dtype=jnp.float32, mesh=jax_mesh(1))[0]),
        ("torch", lambda: distributed_grid_solve(
            A, b, (n + 1, n + 1), F=2, tol=1e-8, maxiter=500, pallas=False,
            dtype=torch.float32, mesh=device_mesh("cpu"))[0]))
    for name, run in runs:
        t0 = time.perf_counter()
        res = run()
        tr = np.linalg.norm(b - A.matvec(res.x)) / np.linalg.norm(b)
        print(f"{name} n={n}: iterations {res.niters} converged "
              f"{res.converged} true rel residual {tr:.4e} "
              f"{res.dist_info} | {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
