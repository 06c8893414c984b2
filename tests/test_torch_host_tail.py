"""The structured route's host tail and its production configuration, of
tpuamg_torch against the JAX package's, on the CPU: the native tail
executor (native/tailkit.cpp) against the torch-CPU tail and the JAX
package's build, pcg_split, host_tail against the unified hybrid, the
production configuration of run_solver_3d1d's structured route (float32
storage, float64 Krylov vectors, the factored outer operator, refine=3,
the host tail), run_solver_3d1d's structured keyword set, and the one
JAX unified structured solve (gamma 1e8) against the port's.  Sizes are
the JAX tests' (tests/test_3d1d_structured.py, tests/test_native_tail.py).
"""
import logging
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpuamg.amg import setup_amg as j_setup_amg
from tpuamg.config import AMGParameters as JP
from tpuamg.fem import unit_cube_mesh
from tpuamg.native.tail import build_native_tail as j_native_tail
from tpuamg.problems import solve as jsolve
from tpuamg.problems.emi_3d1d import get_system, synthetic_neuron_curve
from tpuamg_torch import state
from tpuamg_torch.config import AMGParameters as TP
from tpuamg_torch.native import tail as ttail
from tpuamg_torch.problems import emi_3d1d as TE
from tpuamg_torch.problems import run_solver_3d1d as TR
from tpuamg_torch.problems import solve as tsolve
from tpuamg_torch.sparse.host import HostCSR

# tests/test_native_tail.py's .dat metric-tail configuration
DAT = dict(amg_type="ua", cycle_type="v", maxit=1, smoother="gs",
           aggregation_type="hem", strong_coupled=0.0, max_aggregation=20,
           coarse_dof=60, schwarz_levels=1, schwarz_mmsize=500,
           schwarz_maxlvl=2, coarse_scaling=False, dtype="float64",
           gs_max_colors=6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One torch intra-op thread, one BLAS thread (the Schwarz blocks'
    dense inverses) and two OpenMP threads for the native tails (the
    port's and the JAX package's link the same libgomp): the tier-1
    command's six workers share the host's cores, and eight threads per
    pool in each worker slowed the whole run."""
    import ctypes
    from threadpoolctl import threadpool_limits
    gomp = ctypes.CDLL("libgomp.so.1")
    n, m = torch.get_num_threads(), gomp.omp_get_max_threads()
    torch.set_num_threads(1)
    gomp.omp_set_num_threads(2)
    with threadpool_limits(1, user_api="blas"):
        yield
    gomp.omp_set_num_threads(m)
    torch.set_num_threads(n)


def _system(gamma, n=6, n_main=16, n_branches=2, coupling=False):
    mesh3d = unit_cube_mesh(n)
    curve = synthetic_neuron_curve(n_main=n_main, n_branches=n_branches)
    g = gamma * 2 * np.pi * 0.2
    out = get_system(mesh3d, curve, k3=3.0, k1=7.0 * np.pi * 0.04, gamma=g,
                     coupling_radius=0.2, return_coupling=coupling)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    A, b, sizes = out[:3]
    idofs = np.arange(sizes[0], sum(sizes))
    if coupling:
        Pi, Mq = out[3]
        return A, b, sizes, coords, idofs, (g, Pi, Mq)
    return A, b, sizes, coords, idofs


def _port(A):
    return HostCSR(np.asarray(A.indptr), np.asarray(A.indices),
                   np.asarray(A.data), A.shape)


def _rel(got, ref):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(ref))
                 / np.linalg.norm(np.asarray(ref)))


def _true(A, b, x):
    return float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the native tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma,cluster", [(1e0, False), (1e8, True)])
def test_native_tail_matches_torch_and_jax(gamma, cluster):
    """On one residual: the port's tailkit build equals the JAX package's
    build of the same source on the same hierarchy (to 1e-12; it reads
    0), and the torch-CPU tail to 1e-12 at gamma 1.  At gamma 1e8 the
    metric rows' conditioning amplifies summation-order differences
    (CSR rows against padded ELL rows): native against torch reads
    1.1e-9 .. 3.0e-9 there, as the JAX package's native against its jax
    tail (2.2e-9 .. 5.2e-9), so it is held to that test's 1e-7
    (tests/test_native_tail.py::_parity)."""
    A, _, _, _, idofs = _system(gamma, n=5, n_main=12)
    jp = j_setup_amg(A, JP(**DAT, schwarz_cluster=cluster), idofs=idofs)
    tp = state.amg_hierarchy_from_jax(jp, "cpu")
    tn, jn = ttail.build_native_tail(tp), j_native_tail(jp)
    assert tn is not None and jn is not None
    r = np.random.default_rng(0).standard_normal(A.shape[0])
    ec = tn.apply(r)
    assert _rel(ec, jn.apply(r)) <= 1e-12
    assert _rel(ec, tp.matvec(torch.as_tensor(r)).numpy()) <= (
        1e-12 if gamma == 1e0 else 1e-7)


def test_native_tail_of_the_port_setup():
    """build_native_tail on the port's own setup_amg (GS tail levels with
    coarse_scaling): the torch-CPU tail to 1e-12."""
    A, _, _, _, idofs = _system(1e2, n=5, n_main=12)
    tp = tsolve.setup_amg(_port(A), TP(**dict(DAT, schwarz_levels=0,
                                               coarse_scaling=True)),
                          device="cpu")
    tn = ttail.build_native_tail(tp)
    assert tn is not None
    r = np.random.default_rng(1).standard_normal(A.shape[0])
    assert _rel(tn.apply(r), tp.matvec(torch.as_tensor(r)).numpy()) <= 1e-12


def test_native_tail_declines_with_a_log_line(caplog, monkeypatch):
    """SA transfers, a W-cycle and TPUAMG_NO_NATIVE_TAIL: None, and one
    log line naming why (the JAX package's fallback, no longer silent)."""
    A, _, _, _, idofs = _system(1e2, n=5, n_main=12)
    At = _port(A)
    gs = dict(DAT, schwarz_levels=0)    # the reasons need no Schwarz blocks
    sa = tsolve.setup_amg(At, TP(**dict(gs, amg_type="sa")), device="cpu")
    w = tsolve.setup_amg(At, TP(**dict(gs, cycle_type="w")), device="cpu")
    ua = tsolve.setup_amg(At, TP(**gs), device="cpu")
    with caplog.at_level(logging.WARNING, logger=ttail.__name__):
        assert ttail.build_native_tail(sa) is None
        assert "SA transfers" in caplog.text
        assert ttail.build_native_tail(w) is None
        assert "cycle 'w'" in caplog.text
        monkeypatch.setenv("TPUAMG_NO_NATIVE_TAIL", "1")
        assert ttail.build_native_tail(ua) is None
        assert "TPUAMG_NO_NATIVE_TAIL" in caplog.text
    assert len(caplog.records) == 3


# ---------------------------------------------------------------------------
# host_tail and pcg_split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tail_solves():
    """The JAX package's host-tail solve at gamma 1e8 (tests/
    test_3d1d_structured.py::test_host_tail_split_parity's configuration:
    algebraic_below 700, every dof in the tail), once.  The split with a
    device window level (algebraic_below 300) is held to the port's
    unified hybrid below and in test_cycle_down_up_is_the_cycle: the JAX
    package's compile of that split costs about 40 s here."""
    A, b, sizes, coords, idofs = _system(1e8)
    out = {}
    for ab in (700,):
        kw = dict(params=JP(cycle_type="v", dtype="float64",
                            schwarz_levels=2), tol=1e-8, maxiter=150,
                  structured_coords=coords, idofs=idofs, pallas=False,
                  algebraic_below=ab)
        out[ab] = jsolve.solve_system(A, b, "metric_mono", sizes,
                                      host_tail=True, **kw)
    return A, b, sizes, coords, idofs, out


def _tkw(coords, idofs, ab, **prm):
    return dict(params=TP(cycle_type="v", dtype="float64", schwarz_levels=2,
                          **prm),
                tol=1e-8, maxiter=150, structured_coords=coords,
                idofs=idofs, pallas=False, algebraic_below=ab, device="cpu")


@pytest.mark.parametrize("ab", [700])
def test_pcg_split_matches_jax(tail_solves, ab):
    """solve_system(host_tail=True) (HostTailHybrid + pcg_split) against
    the JAX package's: the same iterations, x to 1e-8, pcg_split reading
    every iteration (executed = niters)."""
    A, b, sizes, coords, idofs, ref = tail_solves
    rep = tsolve.solve_system(_port(A), b, "metric_mono", sizes,
                              host_tail=True, **_tkw(coords, idofs, ab))
    assert rep.niters == ref[ab].niters and rep.converged
    assert rep.executed == rep.niters
    assert _rel(rep.x, ref[ab].x) <= 1e-8


@pytest.mark.parametrize("ab", [700, 300])
def test_host_tail_matches_unified(tail_solves, ab):
    """tests/test_3d1d_structured.py::test_host_tail_split_parity on the
    port: host_tail against the unified hybrid, at most 1 iteration
    apart and x to 1e-6."""
    A, b, sizes, coords, idofs, _ = tail_solves
    At = _port(A)
    kw = _tkw(coords, idofs, ab)
    r0 = tsolve.solve_system(At, b, "metric_mono", sizes, **kw)
    r1 = tsolve.solve_system(At, b, "metric_mono", sizes, host_tail=True,
                             **kw)
    assert r1.converged and abs(r1.niters - r0.niters) <= 1
    np.testing.assert_allclose(r1.x, r0.x, rtol=1e-6, atol=1e-9)


def test_host_tail_full_tail_coarse_scaling():
    """coarse_scaling with the tail owning every dof (no device window
    levels): the split must skip the boundary scaling, as the unified
    cycle never scales its own top-level output (tests/
    test_3d1d_structured.py::test_host_tail_full_tail_coarse_scaling_
    parity on the port)."""
    A, b, sizes, coords, idofs = _system(1e6)
    At = _port(A)
    kw = _tkw(coords, idofs, 10 ** 9, coarse_scaling=True)
    r0 = tsolve.solve_system(At, b, "metric_mono", sizes, **kw)
    r1 = tsolve.solve_system(At, b, "metric_mono", sizes, host_tail=True,
                             **kw)
    assert r1.converged and abs(r1.niters - r0.niters) <= 1
    np.testing.assert_allclose(r1.x, r0.x, rtol=1e-6, atol=1e-9)


def test_cycle_down_up_is_the_cycle():
    """MGPreconditioner.cycle_up(cycle_down(b), tail(rc)) is the unified
    V-cycle's application (the split's contract), with the tail as the
    unified hierarchy's levels below the boundary and coarse_scaling on:
    HostTailHybrid.tail_apply (native tail) scales the boundary
    correction as the unified cycle does between those levels."""
    from tpuamg_torch.amg.hierarchy import MGPreconditioner
    from tpuamg_torch.amg.structured import HostTailHybrid, setup_structured
    A, _, _, coords, idofs = _system(1e4)
    prm = TP(cycle_type="v", dtype="float64", schwarz_levels=2,
             coarse_scaling=True)
    prec, _, n = setup_structured(_port(A), coords, prm,
                                  dtype=torch.float64, pallas=False,
                                  idofs=idofs, algebraic_below=300,
                                  device="cpu")
    k = sum(type(L).__name__ == "StructuredLevel" for L in prec.levels)
    assert 0 < k < len(prec.levels)
    kw = dict(cycle="v", maxit=1, coarse_scaling=True)
    fine = MGPreconditioner(prec.levels[:k], None, **kw)
    tail = MGPreconditioner(prec.levels[k:], prec.coarse_inv, **kw)
    # the boundary scaling lives in HostTailHybrid.tail_apply
    hybrid = HostTailHybrid(fine, tail, prec.levels[k].A.to_host(),
                            coarse_scaling=True)
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(n))
    carry, rc = fine.cycle_down(b)
    z = fine.cycle_up(carry, torch.as_tensor(hybrid.tail_apply(rc.numpy())))
    assert _rel(z.numpy(), prec.matvec(b).numpy()) <= 1e-12


# ---------------------------------------------------------------------------
# the production configuration and run_solver_3d1d's structured route
# ---------------------------------------------------------------------------

def _production(dtype, gamma=1e8):
    A, b, sizes, coords, idofs, coupling = _system(gamma, coupling=True)
    kw = dict(tol=1e-6, maxiter=100, idofs=idofs, refine=3, inner_tol=2e-5,
              structured_coords=coords, algebraic_below=700,
              host_tail=True)
    return A, b, sizes, coupling, kw


def test_production_configuration_matches_jax():
    """tests/test_3d1d_structured.py::test_host_tail_mixed_precision_
    production_config (f32 storage, f64 Krylov vectors, the factored
    outer operator, refine=3, the host tail) at gamma 1e8, the slice as a
    whole: pass iterations within 1 of the JAX package's and a true
    residual below 1e-6 on both sides.  The port runs its kernel classes
    (pallas None: K1 on AD, here its plain version)."""
    A, b, sizes, coupling, kw = _production(jnp.float32)
    ref = jsolve.solve_system(
        A, b, "metric_mono", sizes,
        params=JP(cycle_type="v", dtype="float32", schwarz_levels=2),
        dtype=jnp.float32, krylov_dtype=jnp.float64, coupling=coupling,
        pallas=False, **kw)
    g, Pi, Mq = coupling
    rep = tsolve.solve_system(
        _port(A), b, "metric_mono", sizes,
        params=TP(cycle_type="v", dtype="float32", schwarz_levels=2),
        dtype=torch.float32, coupling=(g, _port(Pi), _port(Mq)),
        device="cpu", **kw)
    assert ref.converged and rep.converged
    assert len(rep.pass_iters) == len(ref.pass_iters)
    assert all(abs(a - c) <= 1 for a, c in zip(rep.pass_iters,
                                                ref.pass_iters))
    assert rep.r_norm < 1e-6 and ref.r_norm < 1e-6
    assert _true(A, b, rep.x) < 1e-6


def test_split_metric_operator_is_a():
    """The factored outer operator is A in slot space: float64 storage to
    1e-12 on a random vector.  Near the gamma-null space (x1 = Pi x3),
    float32 storage (AD through the K1 operator's plain version, R
    float64) stays within 1e-6 of the float64 factored product, while
    an entrywise float32 A is off by more than 1e-3 there (9.0e-3 on this
    vector: the trap the factored form exists for)."""
    from tpuamg_torch.amg.structured import lattice_tiled_slots
    from tpuamg_torch.sparse.device import ELL
    A, b, sizes, coords, idofs, coupling = _system(1e8, coupling=True)
    g, Pi, Mq = coupling
    At = _port(A)
    slots, nsl = lattice_tiled_slots(coords, idofs, A.shape[0])
    st = torch.as_tensor(slots)

    def op(dt):
        return tsolve._split_metric_operator(
            At, (g, _port(Pi), _port(Mq)), sizes, slots, nsl, dt, None,
            "cpu")

    def in_slots(x):
        xs = torch.zeros(nsl, dtype=torch.float64)
        xs[st] = torch.as_tensor(x)
        return xs
    x = np.random.default_rng(4).standard_normal(A.shape[0])
    f64 = op(torch.float64)
    assert _rel(f64.matvec(in_slots(x)).numpy()[slots], A.matvec(x)) \
        <= 1e-12
    x3 = x[:sizes[0]]
    xn = np.concatenate([x3, Pi.matvec(x3)])
    ref = f64.matvec(in_slots(xn)).numpy()[slots]
    assert _rel(op(torch.float32).matvec(in_slots(xn)).numpy()[slots],
                ref) <= 1e-6
    entry32 = ELL.from_host(At, dtype=torch.float32, device="cpu")
    assert _rel(entry32.matvec(torch.as_tensor(xn)).numpy(), ref) > 1e-3


@pytest.fixture(scope="module")
def dump_dir(tmp_path_factory):
    """A mesh_n 6 dump (radius 0.2, gamma 1e8) with coords and coupling."""
    d = str(tmp_path_factory.mktemp("dump")) + "/"
    assert TE.main(["-gamma", "100000000", "-radius", "0.2", "-dump", "1",
                    "-outdir", d, "-mesh_n", "6", "-n_main", "16",
                    "-n_branches", "2"]) == 0
    return d


def test_run_solver_structured_keywords_match_jax(dump_dir, tmp_path):
    """run_solver_3d1d's structured keyword set (route_keywords, which
    main calls) on the CPU against the JAX package's solve_system with
    the same keywords: pass iterations within 1, true residual <= 1e-6 on
    both; main -route structured takes that route, prints it and equals
    the direct call."""
    from tpuamg.io_utils import (dat_to_amg_parameters as jdat,
                                 load_coupling as jcoupling,
                                 load_system as jload)
    from tpuamg_torch.io_utils import (dat_to_amg_parameters, load_coupling,
                                       load_system)
    prm, cfg = dat_to_amg_parameters(TR.DEFAULT_INFILE)
    A, b, idofs, idofs3d, coords = load_system(dump_dir, with_coords=True)
    sizes = (len(idofs3d), len(b) - len(idofs3d))
    params, kw = TR.route_keywords("structured", prm, cfg, coords=coords,
                                   coupling=load_coupling(dump_dir))
    assert kw["host_tail"] and params.gs_max_colors == 6
    assert "chunk" not in kw and kw["refine"] == 3
    rep = tsolve.solve_system(A, b, "metric_hazmath", sizes, idofs=idofs,
                              params=params, device="cpu", **kw)
    jprm, _ = jdat("tpuamg/problems/input_metric.dat")
    jprm = replace(jprm, schwarz_cluster=True, gs_max_colors=6)
    jA, jb, _, _, jc = jload(dump_dir, with_coords=True)
    jkw = dict(kw, dtype=jnp.float32, krylov_dtype=jnp.float64,
               structured_coords=jc, coupling=jcoupling(dump_dir))
    ref = jsolve.solve_system(jA, jb, "metric_hazmath", sizes, idofs=idofs,
                              params=jprm, **jkw)
    assert rep.converged and ref.converged
    assert len(rep.pass_iters) == len(ref.pass_iters)
    assert all(abs(a - c) <= 1 for a, c in zip(rep.pass_iters,
                                                ref.pass_iters))
    assert _true(A, b, rep.x) <= 1e-6 and _true(jA, jb, ref.x) <= 1e-6
    out = str(tmp_path) + "/"
    main = TR.main(["-indir", dump_dir, "-outdir", out, "-route",
                    "structured"], device="cpu")
    assert main.route == "structured"
    assert main.pass_iters == rep.pass_iters
    np.testing.assert_allclose(main.x, rep.x, rtol=0, atol=1e-12)


def test_run_solver_keep_idofs_runs(dump_dir, tmp_path):
    """-keep_idofs 1 with a finite -algebraic_below on the structured
    route: window levels that inject the interface dofs, then the host
    tail; converged to the .dat tolerance."""
    out = str(tmp_path) + "/"
    rep = TR.main(["-indir", dump_dir, "-outdir", out, "-route",
                   "structured", "-keep_idofs", "1", "-algebraic_below",
                   "100"], device="cpu")
    A, b, _, _ = TR.load_system(dump_dir)
    assert rep.converged and _true(A, b, rep.x) <= 1e-6


def test_run_solver_route_rule(dump_dir, monkeypatch):
    """-route auto: the algebraic route with device="cpu" (the JAX
    package's rule off its accelerator), the structured route on the
    card; and the structured route needs coords."""
    assert TR.pick_route("auto", np.zeros((2, 3)), "cpu") == "algebraic"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TR.pick_route("auto", np.zeros((2, 3)), None) == "structured"
    assert TR.pick_route("auto", None, None) == "algebraic"
    assert TR.pick_route("algebraic", np.zeros((2, 3)), None) == \
        "algebraic"
    prm, cfg = TR.dat_to_amg_parameters(TR.DEFAULT_INFILE)
    with pytest.raises(ValueError, match="coords"):
        TR.route_keywords("structured", prm, cfg)


# ---------------------------------------------------------------------------
# the one JAX unified structured solve
# ---------------------------------------------------------------------------

def test_unified_solve_matches_jax():
    """tests/test_3d1d_structured.py::test_3d1d_structured_gamma_robust at
    gamma 1e8, the JAX package run with chunk=1 (its x the crossing
    iterate, as the port's): equal iterations, x to 1e-8, and the true
    residual of both the same crossing iterate (4.9e-7; the JAX test's
    1e-7 holds only for its chunk-end iterate)."""
    A, b, sizes, coords, idofs = _system(1e8)
    ref = jsolve.solve_system(
        A, b, "metric_mono", sizes,
        params=JP(cycle_type="v", dtype="float64", schwarz_levels=2),
        tol=1e-8, maxiter=150, structured_coords=coords, idofs=idofs,
        pallas=False, chunk=1)
    rep = tsolve.solve_system(_port(A), b, "metric_mono", sizes,
                              **_tkw(coords, idofs, 0))
    assert rep.converged and ref.converged
    assert rep.niters == ref.niters
    assert _rel(rep.x, ref.x) <= 1e-8
    assert _true(A, b, rep.x) < 1e-6
