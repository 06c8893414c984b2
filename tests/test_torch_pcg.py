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
    """The JAX pcg with chunk=1 returns the crossing iterate, as the
    port's pcg does with any chunk."""
    A, b = _spd()
    d = 1.0 / np.diag(A)
    seen = []
    res = pcg(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(b),
              M=lambda r: torch.from_numpy(d) * r, tol=1e-8, maxiter=300,
              chunk=7, stop_type=stop_type,
              callback=lambda i, x, r: seen.append(i))
    ref = jax_pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                  M=lambda r: jnp.asarray(d) * r, tol=1e-8, maxiter=300,
                  chunk=1, stop_type=stop_type)
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


# ---------------------------------------------------------------------------
# The crossing iterate: the solve stops at the first iteration that meets
# the stop test, with the histories of an uncut run, and runs M at most
# twice more than it counts
# ---------------------------------------------------------------------------

def _counting(fn):
    """fn wrapped to count its calls (calls[0])."""
    calls = [0]

    def wrapped(*a):
        calls[0] += 1
        return fn(*a)
    return wrapped, calls


def _same_history(got, ref, prefix=False):
    """got's histories equal ref's (prefix: ref's cut to got's length),
    and else its count and cond too."""
    for key in ("residuals", "true_residuals", "alphas", "betas"):
        g = getattr(got, key)
        np.testing.assert_array_equal(g, getattr(ref, key)[:len(g)])
    if not prefix:
        assert got.niters == ref.niters and got.converged == ref.converged
        assert got.cond == ref.cond


def _check_crossing(solve, maxiter, chunk=32):
    """solve(chunk=, tol=None, maxiter=, M counting) -> (result, calls of
    M).  The run against chunk=1 (the exact crossing by construction),
    and against an uncut run (tol 0) to the end of the crossing's chunk:
    its histories are those whole chunks recorded, and its x the iterate
    they returned."""
    got, calls = solve(chunk=chunk)
    one, _ = solve(chunk=1)
    assert got.converged
    _same_history(got, one)
    x, x1 = got.x.double(), one.x.double()
    assert float((x - x1).abs().max()) <= 1e-12 * float(x1.abs().max())
    assert calls <= got.niters + 2, (calls, got.niters)
    assert got.executed + 1 == calls and got.host_reads >= 2
    end = min(-(-got.niters // chunk) * chunk, maxiter)
    full, _ = solve(chunk=chunk, tol=0.0, maxiter=end)
    assert full.niters == end and not full.converged
    _same_history(got, full, prefix=True)
    if end > got.niters:
        assert not torch.equal(got.x, full.x)
    return got


@pytest.mark.parametrize("stop_type", [1, 2, 3])
@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_pcg_returns_the_crossing_iterate(stop_type, tol):
    A, b = _spd()
    d = torch.from_numpy(1.0 / np.diag(A))
    At, bt = torch.from_numpy(A), torch.from_numpy(b)

    def solve(chunk, tol=tol, maxiter=300):
        M, calls = _counting(lambda r: d * r)
        res = pcg(lambda v: At @ v, bt, M=M, tol=tol, maxiter=maxiter,
                  chunk=chunk, stop_type=stop_type)
        return res, calls[0]
    _check_crossing(solve, 300)


def test_pcg_crossing_on_the_slice():
    """The fused f32 cycle as M (route (b) at n=16)."""
    A, b, vc, slots, Aop, bk, _ = _slice(1e6)

    def solve(chunk, tol=1e-6, maxiter=60):
        M, calls = _counting(fused_operator(vc))
        return pcg(Aop, bk, M=M, tol=tol, maxiter=maxiter,
                   chunk=chunk), calls[0]
    got = _check_crossing(solve, 60)
    assert got.niters > 4


@pytest.mark.parametrize("stop_type", [1, 2, 3])
def test_pcg_fused_plain_chunk_returns_the_crossing_iterate(monkeypatch,
                                                            stop_type):
    """pcg_fused over the plain chunk, which stops inside the chunk at
    the crossing: chunk=1's counts, histories, cond and x, the uncut
    run's histories, and one cycle per counted iteration plus z0's."""
    from tpuamg_torch.amg import grid_fused as gf
    A, b, vc, slots, Aop, bk, prm = _slice(1e6)
    fp = gf.FusedPCG(vc, Aop)

    def solve(chunk, tol=1e-6, maxiter=60):
        cyc, calls = _counting(gf.vcycle_plain)
        z0, calls0 = _counting(gf.vcycle)
        monkeypatch.setattr(gf, "vcycle_plain", cyc)
        monkeypatch.setattr(gf, "vcycle", z0)
        res = gf.pcg_fused(fp, bk, tol=tol, maxiter=maxiter, chunk=chunk,
                           stop_type=stop_type)
        return res, calls[0] + calls0[0]
    got = _check_crossing(solve, 60, chunk=8)
    assert got.executed == got.niters


def test_pcg_chunk_plain_stops_at_the_crossing():
    """The plain chunk given a stop test: the carry row says how many
    iterations ran and why, rows past them stay zero, and rz_T is the
    crossing iterate's r.z."""
    from tpuamg_torch.amg.grid_fused import FusedPCG, pcg_chunk_plain
    A, b, vc, slots, Aop, bk, _ = _slice(1e6)
    fp = FusedPCG(vc, Aop)
    bm = bk * vc.mask_flat
    z0 = vc.matvec(bm)

    def start():
        return (torch.zeros_like(bm), bm.clone(), torch.zeros_like(bm),
                z0.clone(), torch.tensor([-1.0]))
    whole = pcg_chunk_plain(fp, *start(), 12)[4].double().numpy()
    res0 = float(torch.dot(bm, z0)) ** 0.5
    thr = float(whole[4, 2]) + 1e-12 * res0     # met first at row 4
    x, r, p, z, st = pcg_chunk_plain(fp, *start(), 12, (2, thr, 0.0))
    st = st.double().numpy()
    assert st[12, 2] == 5 and st[12, 3] == 1
    np.testing.assert_array_equal(st[:5, :5], whole[:5, :5])
    assert np.all(st[5:12] == 0)
    # (rz_T, rz_last): the crossing iterate's r.z and iteration 4's
    np.testing.assert_allclose(st[12, 0], float(torch.dot(r, z)), rtol=1e-6)
    assert np.sqrt(np.float32(abs(st[12, 0]))) == np.float32(st[4, 2])
    np.testing.assert_allclose(np.sqrt(abs(st[12, 1])), st[3, 2], rtol=1e-6)
    assert np.all(whole[12, 2:4] == (12, 0))
