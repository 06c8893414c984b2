"""tpuamg_torch's solve_system (grid branch), refine and the bidomain_2d
driver against the JAX package's.

* Each route of the grid branch at n=16, gamma 1e6, against the JAX
  solve_system with the matching pallas= value: route (a) and (b) against
  "fused_interpret", route (c) f32 NL-AMLI against "interpret", route (c)
  f64 against False.  Iterations within 2, the true relative residual
  under the bound of the matching JAX test.  The JAX solves here run one
  iteration per chunk (chunk=1), so that, as the port's, they return the
  crossing iterate (the first iterate that meets the stop test).
* The routing rule itself (no JAX).
* refine, as tests/test_refine.py holds the JAX package, and against the
  JAX refine on the same system and route (route (c), plain ops): f32
  inner solves (several passes) and f64 inner solves.
* The driver with -backend grid -nrefs 1 -dtype float64 in a temporary
  working directory against the JAX driver (both take route (c) in f64).

The JAX interpret solves are slow, so each runs once, in a module fixture.
"""
import argparse
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest

from tpuamg_torch.config import AMGParameters, PRESETS
from tpuamg_torch.fem import mms
from tpuamg_torch.problems import solve as tsolve
from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system

GRID16 = ((17, 17), 2)
NL_AMLI = replace(PRESETS["metric_schwarz"], cycle_type="nl_amli",
                  amli_degree=2)


def _system(gamma=1e6, n=16):
    p = Params(2.0, 3.0, gamma)
    return get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)


def _rel(A, b, x):
    return np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)


# the JAX solves, keyed by the port's route; (kwargs, tol)
JAX_CASES = {
    "a": (dict(dtype=jnp.float32, pallas="fused_interpret"), 1e-6),
    "c32": (dict(dtype=jnp.float32, pallas="interpret", params=NL_AMLI),
            1e-6),
    "c64": (dict(dtype=jnp.float64, pallas=False), 1e-8),
}


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX solves, one iteration per chunk (its pcg_fused given
    chunk=1, its pcg chunk=1 through solve_system): their x is then the
    crossing iterate, as the port's is."""
    from functools import partial
    from tpuamg.amg import grid_fused as jgf
    from tpuamg.problems.solve import solve_system as jax_solve
    A, b, sizes, _ = _system()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgf, "pcg_fused", partial(jgf.pcg_fused, chunk=1))
        return {key: jax_solve(A, b, "metric_mono", sizes, grid=GRID16,
                               tol=tol, maxiter=100, chunk=1, **kw)
                for key, (kw, tol) in JAX_CASES.items()}


def _port(route_key, **kw):
    A, b, sizes, _ = _system()
    tol = JAX_CASES[route_key][1]
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, grid=GRID16,
                              tol=tol, maxiter=100, device="cpu", **kw)
    return A, b, rep


@pytest.mark.parametrize("route,jax_key,kw", [
    ("a", "a", dict(dtype=np.float32)),
    ("b", "a", dict(dtype=np.float32)),
    ("c", "c32", dict(dtype=np.float32, params=NL_AMLI)),
    ("c", "c64", dict(dtype=np.float64)),
])
def test_route_matches_jax(jax_solves, monkeypatch, route, jax_key, kw):
    if route == "b":
        # route (b) is route (a)'s fused cycle above the size threshold
        monkeypatch.setattr(tsolve, "FUSED_PCG_MAX_DOFS", 0)
    A, b, rep = _port(jax_key, **kw)
    ref = jax_solves[jax_key]
    assert rep.route == route
    assert rep.converged and ref.converged
    assert abs(rep.niters - ref.niters) <= 2, (rep.niters, ref.niters)
    rel, rel_ref = _rel(A, b, rep.x), _rel(A, b, ref.x)
    if jax_key == "c64":
        # tests/test_grid_path.py::test_grid_bidomain_gamma_robust, and
        # the solution itself (test_grid_matches_algebraic_solution)
        assert rel < 1e-7
        np.testing.assert_allclose(rep.x, ref.x, atol=1e-7)
        assert np.isfinite(rep.cond) and rep.cond > 1
    else:
        # tests/test_pallas.py::test_grid_path_pallas_interpret_end_to_end
        assert rel < 2 * max(rel_ref, 1e-5), (rel, rel_ref)


def test_route_c_f32_kernel_classes_match_plain():
    """Route (c) in f32 with the kernel classes (K3 and K1; their plain
    versions on the CPU) against pallas=False (plain torch classes)."""
    A, b, rep = _port("c32", dtype=np.float32, params=NL_AMLI)
    _, _, plain = _port("c32", dtype=np.float32, params=NL_AMLI,
                        pallas=False)
    assert rep.route == plain.route == "c"
    assert rep.converged and plain.converged
    assert abs(rep.niters - plain.niters) <= 2
    assert _rel(A, b, rep.x) < 2 * max(_rel(A, b, plain.x), 1e-5)


@pytest.mark.parametrize("params,dtype,pallas,route", [
    (PRESETS["metric_schwarz"], np.float32, None, "a"),          # W
    (replace(PRESETS["metric_schwarz"], cycle_type="v"), np.float32,
     "fused", "a"),
    (NL_AMLI, np.float32, None, "c"),
    (replace(PRESETS["metric_schwarz"], cycle_type="amli"), np.float32,
     None, "c"),
    (replace(PRESETS["metric_schwarz"], cycle_type="fmg"), np.float32,
     None, "c"),
    (replace(PRESETS["metric_schwarz"], cycle_type="add"), np.float32,
     None, "c"),
    (replace(PRESETS["metric_schwarz"], maxit=2), np.float32, None, "c"),
    (PRESETS["metric_schwarz"], np.float64, None, "c"),
    (PRESETS["metric_schwarz"], np.float32, True, "c"),
    (PRESETS["metric_schwarz"], np.float32, False, "c"),
])
def test_routing_rule(params, dtype, pallas, route):
    """The JAX package's rule (solve.py:369-415, on its accelerator);
    whether a card is present plays no part."""
    A, b, sizes, _ = _system(1e6, n=8)
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, grid=((9, 9), 2),
                              params=params, dtype=dtype, pallas=pallas,
                              tol=1e-6, maxiter=60, device="cpu")
    assert rep.route == route
    assert rep.converged and _rel(A, b, rep.x) < 1e-4


def test_unported_branches_raise():
    """The algebraic branch (no grid, and -precond diag with one), MINRES
    on the grid branch and the structured branch (item 10) run; the
    structured branch's unported footprint solvers, rank1g and deflate
    (item 13), raise."""
    A, b, sizes, _ = _system(1e2, n=8)
    idofs = np.arange(sizes[0], len(b))
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, idofs=idofs,
                              device="cpu")
    assert rep.converged and rep.route == "" and _rel(A, b, rep.x) < 1e-6
    from tpuamg_torch.sparse.host import extract_diag_blocks
    rep = tsolve.solve_system(A, b, "diag", sizes, grid=((9, 9), 2),
                              blocks=extract_diag_blocks(A, sizes),
                              device="cpu")
    assert rep.converged and rep.route == "" and _rel(A, b, rep.x) < 1e-6
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, grid=((9, 9), 2),
                              method="minres", device="cpu")
    assert rep.converged and rep.route == "c" and _rel(A, b, rep.x) < 1e-6
    mesh = get_mesh(8, 2)
    coords = np.concatenate([mesh.vertices, mesh.vertices])
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, idofs=idofs,
                              structured_coords=coords, pallas=False,
                              device="cpu")
    assert rep.converged and rep.route == "structured"
    assert _rel(A, b, rep.x) < 1e-6
    for fps in ("rank1g", "deflate"):
        with pytest.raises(ValueError, match="item 13"):
            tsolve.solve_system(A, b, "metric_mono", sizes,
                                structured_coords=coords, fp_solver=fps,
                                device="cpu")


# ---------------------------------------------------------------------------
# refine (tests/test_refine.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [1e0, 1e6])
def test_refinement_reaches_1e10_with_f32_inner(gamma):
    A, b, sizes, _ = _system(gamma)
    prm = AMGParameters(cycle_type="v", dtype="float32")
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, params=prm,
                              tol=1e-10, maxiter=80, grid=GRID16,
                              dtype=np.float32, refine=8, inner_tol=1e-5,
                              device="cpu")
    assert rep.route == "a"
    assert rep.converged, rep.r_norm
    assert _rel(A, b, rep.x) < 1e-10
    assert sum(rep.pass_iters) == rep.niters and len(rep.pass_iters) >= 2
    assert len(rep.residuals) >= len(rep.pass_iters) + 1
    # a single f32 solve cannot reach this
    rep1 = tsolve.solve_system(A, b, "metric_mono", sizes, params=prm,
                               tol=1e-10, maxiter=200, grid=GRID16,
                               dtype=np.float32, device="cpu")
    assert _rel(A, b, rep1.x) > 1e-9


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_refine_matches_jax(dtype):
    """The f64 defect correction around route (c)'s inner solve
    (pallas=False, plain ops in both packages): the same passes, each
    within one iteration, and the same final true residual within the
    spread of f32 rounding (f32 inner) or to rounding (f64 inner)."""
    from tpuamg.problems.solve import solve_system as jax_solve
    A, b, sizes, _ = _system()
    kw = dict(grid=GRID16, tol=1e-10, maxiter=100, pallas=False,
              refine=6, inner_tol=1e-3)
    # chunk=1: each JAX inner solve's x, and so the next pass's defect,
    # is the crossing iterate, as the port's is
    ref = jax_solve(A, b, "metric_mono", sizes, dtype=jnp.dtype(dtype),
                    chunk=1, **kw)
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, dtype=dtype,
                              device="cpu", **kw)
    assert rep.route == "c"
    assert rep.converged and ref.converged
    assert len(rep.pass_iters) == len(ref.pass_iters)
    assert all(abs(p - q) <= 1 for p, q in zip(rep.pass_iters,
                                                ref.pass_iters)), \
        (rep.pass_iters, ref.pass_iters)
    rel, rel_ref = _rel(A, b, rep.x), _rel(A, b, ref.x)
    np.testing.assert_allclose([rel, rel_ref], [rep.r_norm, ref.r_norm],
                               rtol=1e-6)
    if dtype == np.float32:
        # several passes: each lands at the f32 floor of its defect
        assert len(rep.pass_iters) >= 2
        assert rel_ref / 10 <= rel <= 10 * rel_ref, (rel, rel_ref)
    else:
        # each pass returns its crossing iterate, so the last pass lands
        # just under tol (5.9e-11 in both packages), not at the f64 floor
        # that whole chunks' over-solved x reached: the two final true
        # residuals agree to rounding
        assert max(rel, rel_ref) < kw["tol"], (rel, rel_ref)
        np.testing.assert_allclose(rel, rel_ref, rtol=1e-6)


def test_refinement_noop_when_already_converged():
    A, b, sizes, _ = _system(1e2, n=8)
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, tol=1e-8,
                              maxiter=60, grid=((9, 9), 2), refine=4,
                              inner_tol=1e-9, device="cpu")
    # f64 path: the first correction already lands below tol
    assert rep.route == "c"
    assert rep.converged
    assert len(rep.residuals) <= 4


# ---------------------------------------------------------------------------
# the bidomain_2d driver
# ---------------------------------------------------------------------------

def _args(**kw):
    from tpuamg_torch.problems.driver import standard_parser
    from tpuamg_torch.problems.bidomain_2d import PRECONDS
    argv = ["-backend", "grid", "-nrefs", "1", "-dtype", "float64",
            "-gamma", "1e6", "-precond", "metric_mono"]
    for k, v in kw.items():
        argv += [f"-{k}", str(v)]
    return standard_parser("hazmath", PRECONDS).parse_args(argv)


def test_driver_matches_jax(tmp_path, monkeypatch, capsys):
    from tpuamg.problems.bidomain_2d import run as jax_run
    from tpuamg_torch.problems.bidomain_2d import run
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    ref = jax_run(argparse.Namespace(**vars(_args())))
    monkeypatch.chdir(tmp_path / "port")
    got = run(_args(), device="cpu")
    out = capsys.readouterr().out
    assert "ndofs" in out and "|eu1|_1" in out
    (ksp,), (ksp_ref,) = got.table_ksp, ref.table_ksp
    assert ksp[0] == ksp_ref[0] == 2178
    assert abs(ksp[1] - ksp_ref[1]) <= 1, (ksp, ksp_ref)
    (err,), (err_ref,) = got.table_error, ref.table_error
    np.testing.assert_allclose(err[2], err_ref[2], rtol=1e-6)   # |eu1|_1
    np.testing.assert_allclose(err[4], err_ref[4], rtol=1e-6)   # |eu2|_1
    files = sorted(p.name for p in (tmp_path / "port" / "results" /
                                    "bidomain_2d").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax" / "results" /
                                            "bidomain_2d").iterdir())
    assert len(files) == 2


def test_driver_unported_options_raise(tmp_path, monkeypatch):
    """-backend algebraic (the default) and -precond diag run; P2 (item
    11) still raises."""
    from tpuamg_torch.problems.bidomain_2d import run
    monkeypatch.chdir(tmp_path)
    for precond in ("metric_mono", "diag"):
        args = _args()
        args.backend = "algebraic"
        args.precond = precond
        row = run(args, device="cpu").table_ksp[0]
        assert row[0] == 2178 and 0 < row[1] < 500, (precond, row)
    with pytest.raises(NotImplementedError, match="item 11"):
        run(_args(pdegree=2), device="cpu")


def test_compute_errors_p2_raises():
    from tpuamg_torch.problems.bidomain import compute_errors
    with pytest.raises(NotImplementedError, match="item 11"):
        compute_errors(None, None, np.zeros(2), (1, 1), pdegree=2)


def test_signature_follows_jax_order():
    """The parameters solve_system shares with the JAX signature come in
    the same order, so positional calls mean the same in both."""
    import inspect
    from tpuamg.problems.solve import solve_system as jax_solve
    ours = list(inspect.signature(tsolve.solve_system).parameters)
    theirs = list(inspect.signature(jax_solve).parameters)
    shared = [p for p in ours if p in theirs]
    assert shared == [p for p in theirs if p in ours]
    assert ours[:7] == ["A", "b", "precond", "sizes", "idofs", "params",
                        "blocks"]


def test_krylov_dtype_raises_on_the_grid_path():
    A, b, sizes, _ = _system(1e2, n=8)
    with pytest.raises(ValueError, match="krylov_dtype"):
        tsolve.solve_system(A, b, "metric_mono", sizes, grid=((9, 9), 2),
                            dtype=np.float32, krylov_dtype=np.float64,
                            device="cpu")
    rep = tsolve.solve_system(A, b, "metric_mono", sizes, grid=((9, 9), 2),
                              dtype=np.float64, krylov_dtype=np.float64,
                              idofs=np.arange(4), blocks=[], tol=1e-8,
                              maxiter=60, device="cpu")
    assert rep.converged
