"""The chunked fused PCG of tpuamg_torch (pcg_fused, the plain version of
kernel K5 on the CPU) against the JAX package's.

* Against the JAX pcg_fused in interpret mode, on the JAX package's own
  FusedPCG carried across by tpuamg_torch.state (the same cycle planes,
  coarse inverse and f32 outer planes), at n=16, gamma 1e8, V-cycle,
  coarse_dof=128 — with the checks of
  tests/test_grid_fused_pcg.py::test_fused_pcg_matches_reference (the
  second residual at 1e-3: see the test).
* Against the port's own krylov.pcg + vcycle (launch per apply) for V and
  W at gamma 1 and 1e8, the same checks.
* The stats rows' ||r|| against a direct residual
  (tests/test_grid_fused_pcg.py::test_fused_pcg_true_residual), and the
  rz carry across chunk boundaries.
"""
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuamg_torch import state
from tpuamg_torch.amg.grid_fused import (setup_grid_fused_pcg, pcg_fused,
                                         pcg_chunk, fused_operator)
from tpuamg_torch.config import PRESETS
from tpuamg_torch.fem import mms
from tpuamg_torch.krylov import pcg
from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system


def _system(gamma, n=16):
    p = Params(2.0, 3.0, gamma)
    A, b, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    return A, b, n


def _prm(cycle="v"):
    return replace(PRESETS["metric_schwarz"], dtype="float32",
                   cycle_type=cycle, coarse_dof=128)


def _scatter(b, slots, nflat):
    bk = torch.zeros(nflat)
    bk[torch.as_tensor(slots)] = torch.as_tensor(b, dtype=torch.float32)
    return bk


def _true_residual(fp, bk, x):
    return float(torch.linalg.vector_norm(bk - fp.Q.matvec(x)))


def _check_against(got, ref, fp, bk):
    """tests/test_grid_fused_pcg.py:56-68."""
    assert got.converged
    assert abs(got.niters - ref.niters) <= 1, (got.niters, ref.niters)
    # early iterations agree tightly; later ones drift by f32
    # reduction-order noise amplified by the conditioning
    np.testing.assert_allclose(got.residuals[:2], ref.residuals[:2],
                               rtol=1e-4)
    np.testing.assert_allclose(got.alphas[:2], ref.alphas[:2], rtol=1e-4)
    m = min(len(got.residuals), len(ref.residuals))
    np.testing.assert_allclose(got.residuals[:m], ref.residuals[:m],
                               rtol=5e-2)
    assert _true_residual(fp, bk, got.x) <= 2e-6 * got.true_residuals[0]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pcg_fused in interpret mode, once."""
    from tpuamg.amg.grid_fused import setup_grid_fused_pcg as jax_setup
    from tpuamg.amg.grid_fused import pcg_fused as jax_pcg_fused
    A, b, n = _system(1e8)
    jfp, slots, nflat = jax_setup(A, (n + 1, n + 1), F=2, params=_prm(),
                                  cheb_degree=3, interpret=True)
    bj = jnp.zeros(nflat, jnp.float32).at[jnp.asarray(slots)].set(
        jnp.asarray(b, jnp.float32))
    ref = jax_pcg_fused(jfp, bj, tol=1e-6, maxiter=30, chunk=8)
    fp = state.fused_pcg_from_jax(jfp, 2, device="cpu")
    return fp, slots, b, ref


def test_pcg_fused_matches_jax_kernel(jax_run):
    """The checks of test_fused_pcg_matches_reference, but for the second
    preconditioned residual.  That JAX test compares two PCG loops that
    share one cycle implementation; here the two packages' f32 cycles
    differ by their rounding (4e-7 relative in z0 = M b at this size, the
    2e-5 cycle tolerance of tests/test_torch_grid_fused.py), and at gamma
    1e8 the first update r1 = r0 - alpha q cancels ~300-fold, so that
    difference reaches 2.4e-4 in sqrt(r1.z1).  The second residual is
    held at 1e-3; test_pcg_fused_matches_launch_per_apply holds the
    port's two loops, which share the port's cycle, at the JAX test's
    1e-4."""
    fp, slots, b, ref = jax_run
    bk = _scatter(b, slots, fp.vc.nflat)
    got = pcg_fused(fp, bk, tol=1e-6, maxiter=30, chunk=8)
    assert got.converged
    assert abs(got.niters - ref.niters) <= 1, (got.niters, ref.niters)
    np.testing.assert_allclose(got.residuals[0], ref.residuals[0],
                               rtol=1e-4)
    np.testing.assert_allclose(got.residuals[1], ref.residuals[1],
                               rtol=1e-3)
    np.testing.assert_allclose(got.alphas[:2], ref.alphas[:2], rtol=1e-4)
    m = min(len(got.residuals), len(ref.residuals))
    np.testing.assert_allclose(got.residuals[:m], ref.residuals[:m],
                               rtol=5e-2)
    assert _true_residual(fp, bk, got.x) <= 2e-6 * got.true_residuals[0]


def test_carried_outer_operator_matches_own(jax_run):
    """state.fused_pcg_from_jax carries the JAX f32 outer planes, and they
    are the port's own Q on the same system."""
    fp, slots, b, _ = jax_run
    A, _, n = _system(1e8)
    own, own_slots, nflat = setup_grid_fused_pcg(
        A, (n + 1, n + 1), F=2, params=_prm(), device="cpu")
    np.testing.assert_array_equal(own_slots, slots)
    assert own.Q.offsets == fp.Q.offsets and nflat == fp.vc.nflat
    assert own.Q.planes.dtype == torch.float32
    np.testing.assert_array_equal(own.Q.planes.numpy(), fp.Q.planes.numpy())


@pytest.mark.parametrize("cycle", ["v", "w"])
@pytest.mark.parametrize("gamma", [1.0, 1e8])
def test_pcg_fused_matches_launch_per_apply(cycle, gamma):
    A, b, n = _system(gamma)
    fp, slots, nflat = setup_grid_fused_pcg(
        A, (n + 1, n + 1), F=2, params=_prm(cycle), device="cpu")
    bk = _scatter(b, slots, nflat)
    ref = pcg(fp.Q, bk, M=fused_operator(fp.vc), tol=1e-6, maxiter=30,
              chunk=30)
    got = pcg_fused(fp, bk, tol=1e-6, maxiter=30, chunk=8)
    _check_against(got, ref, fp, bk)
    assert _true_residual(fp, bk, ref.x) <= 2e-6 * got.true_residuals[0]


def test_pcg_fused_stats_true_residual():
    """The stats rows' ||r|| is the recurrence residual of the returned
    iterate."""
    A, b, n = _system(1e4)
    fp, slots, nflat = setup_grid_fused_pcg(
        A, (n + 1, n + 1), F=2, params=_prm(), device="cpu")
    bk = _scatter(b, slots, nflat)
    got = pcg_fused(fp, bk, tol=1e-6, maxiter=24, chunk=24)
    r_direct = _true_residual(fp, bk, got.x)
    assert abs(r_direct - got.true_residuals[-1]) <= 1e-3 * max(
        got.true_residuals[0], 1.0)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_pcg_fused_chunk_boundaries(chunk):
    """The (rz_T, rz_last) row carries the recurrence across chunks: any
    chunk length gives the same history as one long chunk."""
    A, b, n = _system(1e6)
    fp, slots, nflat = setup_grid_fused_pcg(
        A, (n + 1, n + 1), F=2, params=_prm(), device="cpu")
    bk = _scatter(b, slots, nflat)
    one = pcg_fused(fp, bk, tol=1e-6, maxiter=24, chunk=24)
    got = pcg_fused(fp, bk, tol=1e-6, maxiter=24, chunk=chunk)
    assert got.niters == one.niters and got.converged == one.converged
    for key in ("residuals", "true_residuals", "alphas", "betas"):
        np.testing.assert_allclose(getattr(got, key), getattr(one, key),
                                   rtol=1e-5, atol=1e-30)


def test_pcg_chunk_first_iteration_sentinel():
    """rz_prev = -1 gives beta = 0 on the first iteration (p = z), and
    the stats layout: row it = (alpha, beta, sqrt|rz|, ||r||, ||x||),
    row chunk = (rz_T, rz_last)."""
    A, b, n = _system(1e6)
    fp, slots, nflat = setup_grid_fused_pcg(
        A, (n + 1, n + 1), F=2, params=_prm(), device="cpu")
    vc = fp.vc
    bm = _scatter(b, slots, nflat) * vc.mask_flat
    z0 = fp.vc.matvec(bm)
    x, r, p = torch.zeros(nflat), bm.clone(), torch.zeros(nflat)
    x, r, p, z, st = pcg_chunk(fp, x, r, p, z0.clone(),
                               torch.tensor([-1.0]), 2)
    st = st.double().numpy()
    rz0 = float(torch.dot(bm, z0))
    q0 = fp.Q.matvec(z0)
    alpha0 = rz0 / float(torch.dot(z0, q0))
    np.testing.assert_allclose(st[0, 0], alpha0, rtol=1e-4)
    rz_t = float(torch.dot(r, z))
    np.testing.assert_allclose(st[2, 0], rz_t, rtol=1e-5)
    np.testing.assert_allclose(st[1, 2], np.sqrt(abs(rz_t)), rtol=1e-5)
    np.testing.assert_allclose(st[1, 3], float(torch.linalg.vector_norm(r)),
                               rtol=1e-5)
    np.testing.assert_allclose(st[1, 4], float(torch.linalg.vector_norm(x)),
                               rtol=1e-5)
    np.testing.assert_allclose(st[1, 1], rz_t / st[2, 1], rtol=1e-5)
    assert np.all(st[:, 5:] == 0)
