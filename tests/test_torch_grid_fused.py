"""The fused grid hierarchy of tpuamg_torch against the JAX package.

* The port's plain cycle, run on the JAX package's own hierarchy (carried
  across by tpuamg_torch.state: the same planes, T and Chebyshev
  parameters), against the f64 MGPreconditioner that
  setup_grid_fused(reference=True) builds on the same canonical hierarchy
  — the oracle of tests/test_grid_fused.py, with its tolerances.
* One case against the JAX fused kernel itself, in interpret mode.
* The port's own setup against the JAX setup, array for array.
"""
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuamg.fem import mms
from tpuamg.problems.bidomain import Params, get_mesh, get_system
from tpuamg.config import AMGParameters, PRESETS
from tpuamg.amg.grid_fused import setup_grid_fused as jax_setup
from tpuamg_torch import state
from tpuamg_torch.amg import grid_fused as tg


def _system(gamma, n=16):
    p = Params(2.0, 3.0, gamma)
    A, b, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    return A


def _port_z(tv, slots, r):
    bk = torch.zeros(tv.nflat)
    bk[torch.as_tensor(slots)] = torch.as_tensor(r, dtype=torch.float32)
    return tv.matvec(bk).numpy()[slots]


@pytest.mark.parametrize("gamma,cycle,kind,rtol", [
    (1.0, "v", 1, 2e-5),
    (1e6, "v", 1, 2e-5),
    (1e4, "v", 4, 2e-5),           # fourth-kind Chebyshev
    # W does ~2x the f32 arithmetic of V: the matching JAX test
    # (test_fused_w_matches_reference_2d) allows 8e-5 for its own kernel
    (1.0, "w", 1, 8e-5),
    (1e6, "w", 1, 8e-5),
])
def test_plain_cycle_matches_reference(gamma, cycle, kind, rtol):
    A = _system(gamma)
    prm = AMGParameters(cycle_type=cycle, maxit=1, coarse_dof=60,
                        dtype="float32")
    vc, slots, nflat, ref, slots_can = jax_setup(
        A, (17, 17), F=2, params=prm, cheb_degree=3, cheb_kind=kind,
        interpret=True, reference=True)
    tv = state.vcycle_from_jax(vc, 2, device="cpu")
    r = np.random.default_rng(3).standard_normal(A.shape[0])
    z = _port_z(tv, slots, r)
    rcan = jnp.zeros(ref.levels[0].A.shape[0]).at[
        jnp.asarray(slots_can)].set(jnp.asarray(r))
    z_ref = np.asarray(ref.matvec(rcan))[slots_can]
    err = np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref)
    assert err < rtol, err


def test_plain_cycle_matches_jax_kernel_interpret():
    """W-cycle (warm second visits) against _mega_kernel itself."""
    A = _system(1.0)
    prm = AMGParameters(cycle_type="w", maxit=1, coarse_dof=60,
                        dtype="float32")
    vc, slots, nflat = jax_setup(A, (17, 17), F=2, params=prm,
                                 cheb_degree=3, interpret=True)
    tv = state.vcycle_from_jax(vc, 2, device="cpu")
    r = np.random.default_rng(4).standard_normal(A.shape[0])
    z = _port_z(tv, slots, r)
    bj = jnp.zeros(nflat, jnp.float32).at[jnp.asarray(slots)].set(
        jnp.asarray(r, jnp.float32))
    z_j = np.asarray(vc.matvec(bj))[slots]
    err = np.linalg.norm(z - z_j) / np.linalg.norm(z_j)
    assert err < 2e-5, err


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_setup_matches_jax(cycle):
    A = _system(1e6)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type=cycle, coarse_dof=60)
    vc, slots, nflat = jax_setup(A, (17, 17), F=2, params=prm,
                                 cheb_degree=4, interpret=True)
    jv = state.vcycle_from_jax(vc, 2, device="cpu")
    tv, tslots, tn = tg.setup_grid_fused(A, (17, 17), F=2, params=prm,
                                         cheb_degree=4, device="cpu")
    np.testing.assert_array_equal(tslots, slots)
    assert tn == jv.nflat and tv.spec.nc == jv.spec.nc
    assert (tv.spec.Kc, tv.spec.rows_c, tv.spec.cycle) == \
        (jv.spec.Kc, jv.spec.rows_c, jv.spec.cycle)
    assert tv.level_nnz == jv.level_nnz and tv.coarse_n == jv.coarse_n
    assert tv.cycle_nnz() == vc.cycle_nnz()
    for lv, (S, J) in enumerate(zip(tv.spec.levels, jv.spec.levels)):
        nd = len(S.offsA)
        # the JAX setup pads every level to one diagonal count with zero
        # planes at offset 0
        assert J.offsA[:nd] == S.offsA, lv
        assert set(J.offsA[nd:]) <= {0}, lv
        assert not torch.any(jv.A_planes[lv][nd:])
        assert (S.lead, S.K, S.rows, S.offsC, S.degree, S.pre, S.post) == \
            (J.lead, J.K, J.rows, J.offsC, J.degree, J.pre, J.post)
        np.testing.assert_allclose(S.theta, J.theta, rtol=1e-12)
        np.testing.assert_allclose(S.coefs, J.coefs, rtol=1e-12)
        torch.testing.assert_close(tv.A_planes[lv], jv.A_planes[lv][:nd],
                                   rtol=0, atol=0)
        torch.testing.assert_close(tv.C_planes[lv], jv.C_planes[lv],
                                   rtol=0, atol=0)
        torch.testing.assert_close(tv.M_planes[lv], jv.M_planes[lv],
                                   rtol=0, atol=0)
    torch.testing.assert_close(tv.mask_flat, jv.mask_flat, rtol=0, atol=0)
    # both invert the coarse operator by f32 LU, with different pivoting
    scale = float(jv.T.abs().max())
    assert float((tv.T - jv.T).abs().max()) < 1e-4 * scale


def test_dims_schedule_and_slots_are_copies():
    from tpuamg.amg.grid import interleave_fields
    from tpuamg.amg.grid_fused import dims_schedule, _kernel_slots
    from tpuamg_torch.amg.grid import interleave_fields as t_interleave
    np.testing.assert_array_equal(t_interleave(289, 2),
                                  interleave_fields(289, 2))
    for dims, F, coarse in (((513, 513), 2, 4096), ((17, 17), 2, 60),
                            ((6, 6, 6), 2, 50)):
        s = tg.dims_schedule(dims, F, 20, coarse)
        assert s == dims_schedule(dims, F, 20, coarse)
        K = int(np.ceil(s[0][-1] * F / 128))
        np.testing.assert_array_equal(tg._kernel_slots(s[0], F, K),
                                      _kernel_slots(s[0], F, K))


def test_plain_cycle_3d_matches_reference():
    """Two leading axes: the restriction and prolongation index maps."""
    p = Params(2.0, 3.0, 1.0)
    A, _, _, _ = get_system(get_mesh(5, 3), mms.setup_bidomain_mms(p, 3), p)
    prm = AMGParameters(cycle_type="v", maxit=1, coarse_dof=50,
                        dtype="float32")
    vc, slots, nflat, ref, slots_can = jax_setup(
        A, (6, 6, 6), F=2, params=prm, cheb_degree=3, interpret=True,
        reference=True)
    tv = state.vcycle_from_jax(vc, 2, device="cpu")
    r = np.random.default_rng(5).standard_normal(A.shape[0])
    z = _port_z(tv, slots, r)
    rcan = jnp.zeros(ref.levels[0].A.shape[0]).at[
        jnp.asarray(slots_can)].set(jnp.asarray(r))
    z_ref = np.asarray(ref.matvec(rcan))[slots_can]
    # tests/test_grid_fused.py's 3D gamma=1 tolerance
    assert np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref) < 2e-6
