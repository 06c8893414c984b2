"""MINRES, GMRES and every ``-precond`` mode of tpuamg_torch's
solve_system (the algebraic branch) against the JAX package's, on the CPU.

* Each mode (diag, hazmath, hazmath_Schwarz, hazmath_HEM, metric,
  metric_mono, metric_hazmath) on the n=16 bidomain system at gamma 1e6,
  float64, tol 1e-8, as the bidomain driver calls it: the same iteration
  count and x to 1e-8 (relative, max norm), cond to 1e-8, the first
  residuals to 1e-6.  The port's PCG and MINRES return the crossing
  iterate (the first iterate that meets the stop test); the JAX solves
  they are held against run one iteration per chunk (chunk=1), which
  returns the same iterate.
* metric_mono with method="minres" and "gmres": the same counts, x, and
  residual histories; MINRES's Lanczos diagnostics too.
* minres and gmres themselves on the n=24 Poisson fixture with a Jacobi
  preconditioner: x, niters, residuals, alphas, betas and the eigenvalue
  estimates against the JAX functions; restarts and maxiter cut-offs.
* MINRES and GMRES on the grid branch's routes (b) and (c), which the JAX
  package allows them on.

The JAX solves run once, in a module fixture.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuamg.fem import (tagged_unit_square, stiffness_matrix, load_vector,
                        apply_bc_monolithic)
from tpuamg.krylov import minres as jminres, gmres as jgmres
from tpuamg.sparse import ELL as JELL

from tpuamg_torch.config import PRESETS
from tpuamg_torch.fem import mms
from tpuamg_torch.krylov import gmres, minres
from tpuamg_torch.problems import solve as tsolve
from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
from tpuamg_torch.sparse import HostCSR
from tpuamg_torch.sparse.device import ELL
from tpuamg_torch.sparse.host import extract_diag_blocks

MODES = ("diag", "hazmath", "hazmath_Schwarz", "hazmath_HEM", "metric",
         "metric_mono", "metric_hazmath")
METHODS = ("minres", "gmres")


def _system(gamma=1e6, n=16):
    p = Params(2.0, 3.0, gamma)
    A, b, sizes, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2),
                                p)
    return A, b, sizes, np.arange(sizes[0], sizes[0] + sizes[1])


def _kwargs(A, sizes, mode):
    """The bidomain driver's dispatch (problems/bidomain_2d.py)."""
    return dict(
        params=PRESETS["metric_schwarz"] if mode in (
            "metric", "metric_mono", "metric_hazmath") else None,
        blocks=extract_diag_blocks(A, sizes) if mode == "diag" else None)


def _cases():
    return [(m, "cg") for m in MODES] + [("metric_mono", m) for m in METHODS]


# The crossing iterate's limit where float64 rounding alone moves it past
# 1e-8: one unit of rounding in each product of A and M moves hazmath's
# (43 iterations) by 1.7e-8 .. 2.6e-8 on the CPU and 2.3e-8 .. 1.1e-7 on
# an H100 (scripts/torch_rounding_floor.py bidomain hazmath; the other
# modes' by at most 1.8e-12).  5e-7 is 4.6x the largest reading.  There
# the iterate at the end of the crossing's 32-iteration chunk is held to
# 1e-8 as well.
CROSSING_X = {"hazmath": 5e-7}


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX solves, one iteration per chunk: solve_system passes
    chunk=1 to its pcg, and its minres is given chunk=1 here (the JAX
    solve_system passes no chunk to minres)."""
    from functools import partial
    from tpuamg.problems import solve as jsolve
    from tpuamg.sparse import HostCSR as JCSR
    from tpuamg.sparse.host import extract_diag_blocks as jblocks
    A, b, sizes, idofs = _system()
    JA = JCSR(A.indptr, A.indices, A.data, A.shape)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsolve, "minres", partial(jminres, chunk=1))
        for mode, method in _cases():
            kw = _kwargs(A, sizes, mode)
            if kw["blocks"] is not None:
                kw["blocks"] = jblocks(JA, sizes)
            out[mode, method] = jsolve.solve_system(
                JA, b, mode, sizes, idofs=idofs, tol=1e-8, maxiter=500,
                method=method, dtype=jnp.float64, chunk=1, **kw)
            if mode in CROSSING_X:      # whole chunks: the chunk-end x
                out[mode, method, "end"] = jsolve.solve_system(
                    JA, b, mode, sizes, idofs=idofs, tol=1e-8,
                    maxiter=500, method=method, dtype=jnp.float64, **kw)
    return out


@pytest.mark.parametrize("mode,method", _cases())
def test_mode_matches_jax(jax_solves, mode, method):
    A, b, sizes, idofs = _system()
    rep = tsolve.solve_system(A, b, mode, sizes, idofs=idofs, tol=1e-8,
                              maxiter=500, method=method, dtype=np.float64,
                              device="cpu", **_kwargs(A, sizes, mode))
    ref = jax_solves[mode, method]
    assert rep.converged and ref.converged
    assert rep.niters == ref.niters, (rep.niters, ref.niters)
    assert len(rep.residuals) == len(ref.residuals)
    err = np.abs(rep.x - ref.x).max() / np.abs(ref.x).max()
    assert err <= CROSSING_X.get(mode, 1e-8), err
    if mode in CROSSING_X:
        # an uncut run to the end of the crossing's chunk: the JAX
        # solve's chunk-end x
        end = -(-rep.niters // 32) * 32
        full = tsolve.solve_system(A, b, mode, sizes, idofs=idofs, tol=0.0,
                                   maxiter=end, method=method,
                                   dtype=np.float64, device="cpu",
                                   **_kwargs(A, sizes, mode))
        whole = jax_solves[mode, method, "end"]
        assert full.niters == end and whole.niters == rep.niters
        err = np.abs(full.x - whole.x).max() / np.abs(whole.x).max()
        assert err <= 1e-8, err
    # the histories agree until roundoff takes over in the long runs
    # (diag: 173 iterations at cond 8e4)
    np.testing.assert_allclose(rep.residuals[:6], ref.residuals[:6],
                               rtol=1e-6)
    if method == "cg":
        np.testing.assert_allclose(rep.cond, ref.cond, rtol=1e-8)
    else:
        assert np.isnan(rep.cond) and np.isnan(ref.cond)
    assert rep.route == ""
    true = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert true < 1e-4, true


def test_refine_on_the_algebraic_branch():
    """refine takes the algebraic branch too: f32 inner solves, float64
    defect correction to a true residual of 1e-10."""
    A, b, sizes, idofs = _system(1e6, n=8)
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, idofs=idofs,
                              params=PRESETS["metric_schwarz"],
                              dtype=np.float32, refine=6, inner_tol=1e-5,
                              tol=1e-10, device="cpu")
    true = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert rep.converged and true < 1e-10 and len(rep.pass_iters) >= 2


def test_krylov_dtype_promotes_the_algebraic_vectors():
    A, b, sizes, idofs = _system(1e6, n=8)
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, idofs=idofs,
                              params=PRESETS["metric_schwarz"],
                              dtype=np.float32, krylov_dtype=np.float64,
                              tol=1e-8, device="cpu")
    assert rep.converged and rep.x.dtype == np.float64


# ---------------------------------------------------------------------------
# minres / gmres themselves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def poisson():
    m = tagged_unit_square(24)
    A = stiffness_matrix(m)
    b = load_vector(m, lambda x: np.ones(len(x)))
    bd = m.boundary_vertices((1, 2, 3, 4))
    A, b = apply_bc_monolithic(A, b, bd, np.zeros(len(bd)))
    T = HostCSR(A.indptr, A.indices, A.data, A.shape)
    E = ELL.from_host(T, dtype=torch.float64, device="cpu")
    J = JELL.from_host(A, dtype=jnp.float64)
    invd = 1.0 / A.diagonal()
    return (E, lambda r: torch.as_tensor(invd) * r,
            J, lambda r: jnp.asarray(invd) * r, b)


@pytest.mark.parametrize("kw", [dict(tol=1e-8), dict(tol=1e-10, chunk=5),
                                dict(tol=1e-12, maxiter=20)])
def test_minres_matches_jax(poisson, kw):
    E, M, J, JM, b = poisson
    got = minres(E, torch.as_tensor(b), M=M, **kw)
    # chunk=1: the JAX minres's x is then the crossing iterate too
    ref = jminres(J, jnp.asarray(b), M=JM, **dict(kw, chunk=1))
    assert got.niters == ref.niters and got.converged == ref.converged
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-12)
    for f in ("residuals", "alphas", "betas"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(got.eigenvalue_estimates(),
                               ref.eigenvalue_estimates(), rtol=1e-9)
    np.testing.assert_allclose(got.cond, ref.cond, rtol=1e-9)


@pytest.mark.parametrize("kw", [dict(tol=1e-8), dict(tol=1e-8, restart=7),
                                dict(tol=1e-12, maxiter=12, restart=5)])
def test_gmres_matches_jax(poisson, kw):
    E, M, J, JM, b = poisson
    got = gmres(E, torch.as_tensor(b), M=M, **kw)
    ref = jgmres(J, jnp.asarray(b), M=JM, **kw)
    assert got.niters == ref.niters and got.converged == ref.converged
    assert len(got.residuals) == got.niters + 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got.residuals, ref.residuals, rtol=1e-6)


def test_zero_rhs_converges_at_once(poisson):
    E, M, _, _, b = poisson
    z = torch.zeros(len(b), dtype=torch.float64)
    for solver in (minres, gmres):
        r = solver(E, z, M=M)
        assert r.converged and r.niters == 0
        assert not torch.any(r.x)


# ---------------------------------------------------------------------------
# the grid branch's routes (b) and (c)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype,route", [(np.float64, "c"),
                                         (np.float32, "b")])
def test_minres_gmres_on_the_grid_branch(method, dtype, route):
    """Route (a) is PCG's alone: with MINRES or GMRES the fused f32 cycle
    takes route (b), as in the JAX package."""
    A, b, sizes, _ = _system(1e6, n=8)
    tol = 1e-8 if dtype == np.float64 else 1e-5
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, grid=((9, 9), 2),
                              tol=tol, maxiter=100, method=method,
                              dtype=dtype, device="cpu")
    assert rep.route == route and rep.converged and np.isnan(rep.cond)
    true = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert true < 1e-3, true


# ---------------------------------------------------------------------------
# The crossing iterate: PCG and MINRES stop at the first iteration that
# meets the stop test, with the histories of an uncut run, and run M at
# most twice more than they count unless a chunk runs past the crossing
# ---------------------------------------------------------------------------

@pytest.fixture
def one_torch_thread():
    """Many small torch ops: with the suite's workers sharing the cores,
    one intra-op thread keeps them from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _algebraic_case():
    """metric_mono's hierarchy on the n=16 bidomain system (gamma 1e6,
    f64), as solve_system builds it, with its ELL outer operator."""
    from tpuamg_torch.sparse.device import matvec_op
    A, b, sizes, idofs = _system()
    M = tsolve.make_preconditioner("metric_mono", A, sizes, idofs=idofs,
                                   params=PRESETS["metric_schwarz"],
                                   device="cpu")
    return (matvec_op(ELL.from_host(A, dtype=torch.float64, device="cpu")),
            M, torch.as_tensor(b))


def _crossing_case(poisson, case, solver):
    """(solve(chunk, tol=1e-12, maxiter=500) -> (result, calls of M))"""
    from tpuamg_torch.krylov import pcg
    if case == "poisson":
        Aop, Mfn, _, _, b = poisson
        b = torch.as_tensor(b)
    else:
        Aop, Mfn, b = _algebraic_case()
    run = {"pcg": pcg, "minres": minres}[solver]

    def solve(chunk, tol=1e-12, maxiter=500):
        calls = [0]

        def M(r):
            calls[0] += 1
            return Mfn(r)
        return run(Aop, b, M=M, tol=tol, maxiter=maxiter,
                   chunk=chunk), calls[0]
    return solve


def _same_as(got, ref, prefix=False):
    """got's histories equal ref's (prefix: ref's cut to got's length),
    and else its count and cond too."""
    for key in ("residuals", "alphas", "betas"):
        g = getattr(got, key)
        np.testing.assert_array_equal(g, getattr(ref, key)[:len(g)])
    if not prefix:
        assert got.niters == ref.niters and got.converged == ref.converged
        assert got.cond == ref.cond


def _x_err(got, ref):
    return float((got.x - ref.x).abs().max() / ref.x.abs().max())


@pytest.mark.parametrize("solver", ["pcg", "minres"])
@pytest.mark.parametrize("case", ["algebraic", "poisson"])
def test_krylov_returns_the_crossing_iterate(poisson, solver, case,
                                            one_torch_thread):
    """chunk=1 is the crossing by construction; an uncut run (tol 0) to
    the end of the crossing's 32-iteration chunk has the histories that
    whole chunks recorded, and its x is the iterate they returned."""
    solve = _crossing_case(poisson, case, solver)
    got, calls = solve(32)
    one, _ = solve(1)
    assert got.converged and got.niters > 4
    _same_as(got, one)
    assert _x_err(got, one) <= 1e-12, _x_err(got, one)
    assert calls <= got.niters + 2 and got.executed + 1 == calls, \
        (calls, got.niters)
    end = min(-(-got.niters // 32) * 32, 500)
    full, _ = solve(32, tol=0.0, maxiter=end)
    assert full.niters == end and not full.converged
    _same_as(got, full, prefix=True)
    assert end == got.niters or not torch.equal(got.x, full.x)


@pytest.mark.parametrize("solver", ["pcg", "minres"])
@pytest.mark.parametrize("case", ["algebraic", "poisson"])
def test_a_chunk_past_the_crossing_is_run_again(poisson, solver, case,
                                               monkeypatch,
                                               one_torch_thread):
    """next_chunk made to over-predict (every chunk after the first is
    ``chunk`` long): the chunk that runs past the crossing is run again
    from its saved start, so x is still the crossing iterate and the
    solve executes that chunk's length more than it counts."""
    from tpuamg_torch.krylov import cg
    solve = _crossing_case(poisson, case, solver)
    one, _ = solve(1)
    sizes = []

    def every_chunk_whole(q, target, cap, last=1):
        sizes.append(cap)
        return cap
    monkeypatch.setattr(cg, "next_chunk", every_chunk_whole)
    got, calls = solve(32)
    _same_as(got, one)
    assert _x_err(got, one) <= 1e-12, _x_err(got, one)
    # chunks of 1, then sizes; the last one holds the crossing
    before = 1 + sum(sizes[:-1])
    assert got.niters - before < sizes[-1], "the case must overshoot"
    assert got.executed == got.niters + sizes[-1], \
        (got.executed, got.niters, sizes)
    assert calls == got.executed + 1


def test_solve_system_reports_executed_iterations(one_torch_thread):
    A, b, sizes, idofs = _system(1e6, n=8)
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, idofs=idofs,
                              params=PRESETS["metric_schwarz"], tol=1e-8,
                              device="cpu")
    assert rep.converged
    assert rep.niters <= rep.executed <= rep.niters + 1
