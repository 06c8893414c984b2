"""tpuamg_torch's PCG against the JAX package's: the Krylov diagnostics on
a small SPD system, and the whole slice (assembly -> fused hierarchy ->
PCG) at n=16."""
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuamg.config import PRESETS
from tpuamg.krylov.cg import pcg as jax_pcg
from tpuamg.sparse.dia import DIA as JDIA
from tpuamg_torch.fem import mms
from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
from tpuamg_torch.amg.grid_fused import (setup_grid_fused, grid_system_fused,
                                         fused_operator)
from tpuamg_torch.krylov import pcg, CGResult


def _spd(n=200, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T / n + np.diag(np.linspace(0.5, 50.0, n))
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("stop_type", [1, 2, 3])
def test_pcg_diagnostics_match_jax(stop_type):
    A, b = _spd()
    d = 1.0 / np.diag(A)
    seen = []
    res = pcg(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(b),
              M=lambda r: torch.from_numpy(d) * r, tol=1e-8, maxiter=300,
              chunk=7, stop_type=stop_type,
              callback=lambda i, x, r: seen.append(i))
    ref = jax_pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                  M=lambda r: jnp.asarray(d) * r, tol=1e-8, maxiter=300,
                  chunk=7, stop_type=stop_type)
    assert isinstance(res, CGResult) and res.converged and ref.converged
    assert res.niters == ref.niters
    assert seen == list(range(1, res.niters + 1))
    np.testing.assert_allclose(res.residuals, ref.residuals, rtol=1e-8)
    np.testing.assert_allclose(res.true_residuals, ref.true_residuals,
                               rtol=1e-8)
    np.testing.assert_allclose(res.alphas, ref.alphas, rtol=1e-8)
    np.testing.assert_allclose(res.cond, ref.cond, rtol=1e-8)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                               atol=1e-10)


def _slice(gamma, n=16, coarse=60):
    p = Params(2.0, 3.0, gamma)
    A, b, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type="v", coarse_dof=coarse)
    vc, slots, nflat = setup_grid_fused(A, (n + 1, n + 1), F=2, params=prm,
                                        cheb_degree=4, device="cpu")
    Aop = grid_system_fused(A, slots, nflat, device="cpu")
    bk = torch.zeros(nflat)
    bk[torch.as_tensor(slots)] = torch.as_tensor(b, dtype=torch.float32)
    return A, b, vc, slots, Aop, bk, prm


def test_slice_pcg_matches_jax():
    """bench.py's slice at n=16, gamma 1e6: the port (f32, its own setup
    and coarse LU) against JAX PCG on the JAX package's f64 reference
    hierarchy built from the same system."""
    from tpuamg.amg.grid_fused import setup_grid_fused as jax_setup
    A, b, vc, slots, Aop, bk, prm = _slice(1e6)
    res = pcg(Aop, bk, M=fused_operator(vc), tol=1e-8, maxiter=60)
    _, _, _, ref_mg, slots_can = jax_setup(
        A, (17, 17), F=2, params=prm, cheb_degree=4, interpret=True,
        reference=True)
    n0 = ref_mg.levels[0].A.shape[0]
    Acan = JDIA(ref_mg.levels[0].A.offsets, ref_mg.levels[0].A.data,
                (n0, n0))
    bc = jnp.zeros(n0).at[jnp.asarray(slots_can)].set(jnp.asarray(b))
    ref = jax_pcg(Acan.matvec, bc, M=ref_mg.matvec, tol=1e-8, maxiter=60)
    assert res.converged and ref.converged
    assert abs(res.niters - ref.niters) <= 1, (res.niters, ref.niters)
    red = res.residuals[-1] / res.residuals[0]
    red_ref = ref.residuals[-1] / ref.residuals[0]
    assert red_ref / 10 <= red <= red_ref * 10, (red, red_ref)
    x = res.x.double().numpy()[slots]
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) < 1e-5


def test_slice_pcg_gamma_1e10():
    """f32 cycles at gamma 1e10 differ from f64 ones by O(5%); parity is
    PCG convergence (tests/test_grid_fused.py::test_fused_pcg_gamma_1e10)."""
    A, b, vc, slots, Aop, bk, _ = _slice(1e10)
    res = pcg(Aop, bk, M=vc, tol=1e-5, maxiter=60)
    assert res.converged and res.niters <= 25, res.niters
