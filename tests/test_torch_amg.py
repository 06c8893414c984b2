"""The algebraic metric-AMG set-up and cycle of tpuamg_torch against the
JAX package's, on the CPU, at the JAX tests' sizes (the n=24 Poisson
fixture of tests/test_amg.py, the n=16 bidomain system at gamma 1e6).

* The native amgkit library: built from the port's own source into
  tpuamg_torch/_build/, and a failed build raises where a card is present.
* Per route (native C++, and numpy with TPUAMG_NO_NATIVE): the port's
  colors, aggregates, MIS seeds and Schwarz blocks are identical to the
  JAX package's on the same route; both routes give valid results.
* ELL, strength, prolongation and every aggregation against the JAX
  functions; the smoothers against the JAX smoothers on the same data.
* setup_amg per level (sizes, level and coarse matrices to 1e-12) for the
  metric_mono preset, hazmath (VMB, NL-AMLI) and SA.
* One cycle of the JAX hierarchy through amg_hierarchy_from_jax, and of
  the port's own set-up, against the JAX cycle (1e-12, float64).
* The Schwarz colour update's scatter through the ghost slot.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuamg.amg import hierarchy as jhier
from tpuamg.amg import aggregation as jagg
from tpuamg.amg import prolongation as jprol
from tpuamg.amg.strength import strength_graph as jstrength
from tpuamg.fem import (tagged_unit_square, stiffness_matrix, load_vector,
                        apply_bc_monolithic, mms as jmms)
from tpuamg.problems import bidomain as jbid
from tpuamg.sparse import ELL as JELL, ell_rows as jrows
from tpuamg.sparse.host import greedy_color as jcolor
from tpuamg.smoothers import relaxation as jrel, schwarz as jsch
from tpuamg.smoothers import schwarz_setup as jss
from tpuamg.config import AMGParameters, PRESETS as JPRESETS

from tpuamg_torch import native, state
from tpuamg_torch.amg import aggregation as tagg
from tpuamg_torch.amg import hierarchy as thier
from tpuamg_torch.amg import prolongation as tprol
from tpuamg_torch.amg.strength import strength_graph as tstrength
from tpuamg_torch.config import AMGParameters as TParams, PRESETS
from tpuamg_torch.sparse import HostCSR as TCSR
from tpuamg_torch.sparse.device import ELL, ell_rows, matvec_op
from tpuamg_torch.sparse.host import greedy_color as tcolor
from tpuamg_torch.smoothers import relaxation as trel, schwarz as tsch
from tpuamg_torch.smoothers import schwarz_setup as tss

CPU = "cpu"
ROUTES = ("native", "numpy")
NAMES = tuple(jagg.AGGREGATORS)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _same_csr(a, b, tol=1e-12):
    assert a.shape == b.shape
    np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=tol,
                               atol=tol * np.abs(b.data).max())


@pytest.fixture(scope="module")
def poisson():
    """tests/test_amg.py's fixture (n=24), as both packages' HostCSR."""
    m = tagged_unit_square(24)
    A = stiffness_matrix(m)
    b = load_vector(m, lambda x: np.ones(len(x)))
    bd = m.boundary_vertices((1, 2, 3, 4))
    A, b = apply_bc_monolithic(A, b, bd, np.zeros(len(bd)))
    return TCSR(A.indptr, A.indices, A.data, A.shape), A, b


@pytest.fixture(scope="module")
def bidomain():
    p = jbid.Params(2.0, 3.0, 1e6)
    A, b, sizes, _ = jbid.get_system(jbid.get_mesh(16, 2),
                                     jmms.setup_bidomain_mms(p, 2), p)
    idofs = np.arange(sizes[0], sizes[0] + sizes[1])
    return TCSR(A.indptr, A.indices, A.data, A.shape), A, b, idofs


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("TPUAMG_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("TPUAMG_NO_NATIVE", raising=False)
    return request.param


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------

def test_native_builds_from_the_repo_source():
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert path.is_file() and path.parent.name == "_build"
    assert path.parent.parent.name == "tpuamg_torch"
    assert native.SOURCE.parent.name == "native"


def test_failed_native_build_raises_on_a_card(monkeypatch):
    def no_compiler():
        raise RuntimeError("g++ missing")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.setattr(native, "build", no_compiler)
    monkeypatch.setattr(native, "_card_present", lambda: False)
    assert native.get_lib() is None           # off the card: numpy route
    monkeypatch.setattr(native, "_card_present", lambda: True)
    with pytest.raises(RuntimeError, match="did not build"):
        native.get_lib()
    A = TCSR.from_dense(np.eye(3) + np.eye(3, k=1) + np.eye(3, k=-1))
    with pytest.raises(RuntimeError, match="did not build"):
        tcolor(A)


def test_native_wrappers_match_jax_native(poisson):
    from tpuamg import native as jnative
    TA, JA, _ = poisson
    S_t, S_j = tstrength(TA, 0.1), jstrength(JA, 0.1)
    np.testing.assert_array_equal(native.native_hem(S_t),
                                  jnative.native_hem(S_j))
    cand = np.arange(0, TA.shape[0], 3)
    np.testing.assert_array_equal(native.native_mis(S_t, cand),
                                  jnative.native_mis(S_j, cand))
    C_t, C_j = native.native_spgemm(TA, TA), jnative.native_spgemm(JA, JA)
    _same_csr(C_t, C_j)
    rng = np.random.default_rng(5)
    r, c = rng.integers(0, 300, 9000), rng.integers(0, 300, 9000)
    v = rng.standard_normal(9000)
    for a, b in zip(native.native_coo_to_csr(r, c, v, (300, 300)),
                    jnative.native_coo_to_csr(r, c, v, (300, 300))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# per route: identical to the JAX package, valid either way
# ---------------------------------------------------------------------------

def _valid_coloring(A, colors, cap):
    r, c, _ = A.to_coo()
    off = (r != c) & (colors[r] < cap) & (colors[c] < cap)
    assert not np.any(colors[r[off]] == colors[c[off]])


def test_colors_identical_per_route(bidomain, route):
    TA, JA, _, _ = bidomain
    for cap in (24, 3):
        got, ref = tcolor(TA, cap), jcolor(JA, cap)
        np.testing.assert_array_equal(got, ref)
        _valid_coloring(TA, got, cap)


def test_routes_both_valid_and_may_differ(bidomain, monkeypatch):
    """The trap of the two routes: each is valid, and they need not agree
    (the native MIS walks the candidates in index order, the numpy one in
    the order given)."""
    TA, _, _, _ = bidomain
    S = tstrength(TA, 0.1)
    G = tss.pattern_power(TA, 1)
    cand = np.arange(TA.shape[0] - 1, 0, -2)
    out = {}
    for r in ROUTES:
        if r == "numpy":
            monkeypatch.setenv("TPUAMG_NO_NATIVE", "1")
        out[r] = (tcolor(TA), tagg.vmb_aggregation(S), tss.greedy_mis(G,
                                                                    cand))
    for colors, (agg, nagg), seeds in out.values():
        _valid_coloring(TA, colors, 24)
        assert (agg >= 0).all() and agg.max() == nagg - 1
        assert set(seeds) <= set(cand)
        reach = G.matvec(np.isin(np.arange(TA.shape[0]), seeds) * 1.0)
        assert (reach[cand] > 0).all()          # dominating
        assert (reach[seeds] == 1).all()        # independent
    assert not np.array_equal(out["native"][2], out["numpy"][2])
    _same_csr(TA.matmat(TA), TCSR.from_dense(TA.toarray() @ TA.toarray()))


def test_aggregates_and_mis_identical_per_route(poisson, bidomain, route):
    for TA, JA in ((poisson[0], poisson[1]), (bidomain[0], bidomain[1])):
        S_t, S_j = tstrength(TA, 0.1), jstrength(JA, 0.1)
        agg, nagg = tagg.vmb_aggregation(S_t)
        ragg, rnagg = jagg.vmb_aggregation(S_j)
        np.testing.assert_array_equal(agg, ragg)
        assert nagg == rnagg
        G_t, G_j = tss.pattern_power(TA, 1), jss.pattern_power(JA, 1)
        cand = np.arange(1, TA.shape[0], 2)
        np.testing.assert_array_equal(tss.greedy_mis(G_t, cand),
                                      jss.greedy_mis(G_j, cand))


@pytest.mark.parametrize("cluster", [False, True])
def test_schwarz_blocks_identical_per_route(bidomain, route, cluster):
    TA, JA, _, idofs = bidomain
    kw = dict(maxlvl=2, mmsize=40, cluster=cluster)
    got = tss.build_schwarz_fast(TA, idofs, dtype=torch.float64,
                                 device=CPU, **kw)
    ref = jss.build_schwarz_fast(JA, idofs, dtype=jnp.float64, **kw)
    assert len(got.dof_ids) == len(ref.dof_ids)
    for gi, ri, gv, rv in zip(got.dof_ids, ref.dof_ids, got.inv_blocks,
                              ref.inv_blocks):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-12,
                                   atol=1e-12 * np.abs(rv).max())


# ---------------------------------------------------------------------------
# ELL, strength, prolongation, aggregation
# ---------------------------------------------------------------------------

def test_ell_matches_jax(bidomain):
    TA, JA, _, _ = bidomain
    E = ELL.from_host(TA, dtype=torch.float64, device=CPU)
    R = JELL.from_host(JA, dtype=jnp.float64)
    np.testing.assert_array_equal(E.cols.numpy(), np.asarray(R.cols))
    assert E.cols.dtype == torch.int64 and E.shape == R.shape
    assert E.nnz == R.nnz and E.row_width == R.row_width
    x = np.random.default_rng(1).standard_normal(TA.shape[0])
    bb = np.random.default_rng(2).standard_normal(TA.shape[0])
    ids = np.arange(3, TA.shape[0], 7)
    for got, ref in ((E.matvec(_t(x)), R.matvec(jnp.asarray(x))),
                     (E @ _t(x), R @ jnp.asarray(x)),
                     (matvec_op(E)(_t(x)), R.matvec(jnp.asarray(x))),
                     (E.residual(_t(x), _t(bb)),
                      R.residual(jnp.asarray(x), jnp.asarray(bb))),
                     (E.matvec_rows(_t(x), _t(ids)),
                      R.matvec_rows(jnp.asarray(x), jnp.asarray(ids))),
                     (ell_rows(E, ids).matvec(_t(x)),
                      jrows(R, ids).matvec(jnp.asarray(x))),
                     (E.diagonal(), R.diagonal()),
                     (E.l1_row_norms(), R.l1_row_norms())):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    assert E.astype(torch.float32).dtype == torch.float32
    _same_csr(E.to_host(), TA)
    W = ELL.from_host(TA, width=E.row_width + 3, device=CPU)
    assert W.row_width == E.row_width + 3 and W.dtype == torch.float32


@pytest.mark.parametrize("theta", [0.0, 0.1, 0.25])
def test_strength_and_prolongation_match_jax(poisson, bidomain, theta):
    for TA, JA in ((poisson[0], poisson[1]), (bidomain[0], bidomain[1])):
        S_t, S_j = tstrength(TA, theta), jstrength(JA, theta)
        _same_csr(S_t, S_j)
        _same_csr(tprol.filtered_matrix(TA, theta),
                  jprol.filtered_matrix(JA, theta))
        agg, nagg = jagg.hem_aggregation(S_j)
        for norm in (False, True):
            _same_csr(tprol.tentative_prolongator(agg, nagg, norm),
                      jprol.tentative_prolongator(agg, nagg, norm))
        P_j = jprol.tentative_prolongator(agg, nagg)
        P_t = TCSR(P_j.indptr, P_j.indices, P_j.data, P_j.shape)
        _same_csr(tprol.smoothed_prolongator(TA, P_t, theta),
                  jprol.smoothed_prolongator(JA, P_j, theta))


@pytest.mark.parametrize("name", NAMES)
def test_every_aggregation_matches_jax(poisson, bidomain, name):
    for TA, JA in ((poisson[0], poisson[1]), (bidomain[0], bidomain[1])):
        agg, nagg = tagg.AGGREGATORS[name](tstrength(TA, 0.1))
        ragg, rnagg = jagg.AGGREGATORS[name](jstrength(JA, 0.1))
        np.testing.assert_array_equal(agg, ragg)
        assert nagg == rnagg and (agg >= 0).all()
        assert nagg < 0.8 * TA.shape[0]


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------

def _vecs(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


def _smooth_pair(got, ref, TA, JA, iters=1, reverse=False):
    x, bb = _vecs(TA.shape[0])
    E = ELL.from_host(TA, dtype=torch.float64, device=CPU)
    R = JELL.from_host(JA, dtype=jnp.float64)
    xt = _t(x)
    y = got.smooth(E, xt, _t(bb), iters=iters, reverse=reverse)
    assert torch.equal(xt, _t(x))          # the caller's x is untouched
    yr = np.asarray(ref.smooth(R, jnp.asarray(x), jnp.asarray(bb),
                               iters=iters, reverse=reverse))
    np.testing.assert_allclose(y.numpy(), yr, rtol=1e-12,
                               atol=1e-12 * np.abs(yr).max())


@pytest.mark.parametrize("kind", ["jacobi", "l1_jacobi", "chebyshev",
                                  "chebyshev_masked"])
def test_pointwise_smoothers_match_jax(bidomain, kind):
    TA, JA, _, idofs = bidomain
    f64 = dict(dtype=torch.float64, device=CPU)
    jf64 = dict(dtype=jnp.float64)
    mask = np.ones(TA.shape[0], dtype=bool)
    mask[idofs] = False
    got, ref = {
        "jacobi": (trel.build_jacobi(TA, 0.8, **f64),
                   jrel.build_jacobi(JA, 0.8, **jf64)),
        "l1_jacobi": (trel.build_l1_jacobi(TA, **f64),
                      jrel.build_l1_jacobi(JA, **jf64)),
        "chebyshev": (trel.build_chebyshev(TA, degree=3, **f64),
                      jrel.build_chebyshev(JA, degree=3, **jf64)),
        "chebyshev_masked": (
            trel.build_chebyshev(TA, degree=2, active=mask, **f64),
            jrel.build_chebyshev(JA, degree=2, active=mask, **jf64)),
    }[kind]
    _smooth_pair(got, ref, TA, JA, iters=2)


@pytest.mark.parametrize("symmetric,reverse,cap,active", [
    (True, False, 24, False), (False, False, 24, False),
    (False, True, 24, True), (True, False, 2, False)])
def test_multicolor_gs_matches_jax(bidomain, symmetric, reverse, cap,
                                   active):
    TA, JA, _, idofs = bidomain
    act = None
    if active:
        act = np.ones(TA.shape[0], dtype=bool)
        act[idofs] = False
    got = trel.build_multicolor_gs(TA, omega=1.1, symmetric=symmetric,
                                   active=act, max_colors=cap,
                                   dtype=torch.float64, device=CPU)
    ref = jrel.build_multicolor_gs(JA, omega=1.1, symmetric=symmetric,
                                   active=act, max_colors=cap,
                                   dtype=jnp.float64)
    assert len(got.color_ids) == len(ref.color_ids)
    seen = np.concatenate([i.numpy() for i in got.color_ids])
    assert len(np.unique(seen)) == len(seen)      # colors are disjoint
    for gi, ri, gd, rd in zip(got.color_ids, ref.color_ids,
                              got.color_invd, ref.color_invd):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-14)
    _smooth_pair(got, ref, TA, JA, iters=2, reverse=reverse)


@pytest.mark.parametrize("setup,kw", [
    ("fast", dict(maxlvl=1, mmsize=100)),
    ("fast", dict(maxlvl=2, mmsize=30, symmetric=False)),
    ("bfs", dict(maxlvl=1, mmsize=100)),
    ("bfs", dict(maxlvl=2, mmsize=50, additive=True, weight=0.5)),
])
def test_schwarz_smoothers_match_jax(bidomain, setup, kw):
    TA, JA, _, idofs = bidomain
    if setup == "fast":
        got = tss.build_schwarz_fast(TA, idofs, dtype=torch.float64,
                                     device=CPU, **kw)
        ref = jss.build_schwarz_fast(JA, idofs, dtype=jnp.float64, **kw)
    else:
        got = tsch.build_schwarz(TA, idofs=idofs, dtype=torch.float64,
                                 device=CPU, **kw)
        ref = jsch.build_schwarz(JA, idofs=idofs, dtype=jnp.float64, **kw)
    for gi, ri in zip(got.dof_ids, ref.dof_ids):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    _smooth_pair(got, ref, TA, JA)
    _smooth_pair(got, ref, TA, JA, reverse=True)
    mask = np.ones(TA.shape[0], dtype=bool)
    mask[idofs] = False
    gs_t = trel.build_multicolor_gs(TA, symmetric=False, active=mask,
                                    dtype=torch.float64, device=CPU)
    gs_j = jrel.build_multicolor_gs(JA, symmetric=False, active=mask,
                                    dtype=jnp.float64)
    _smooth_pair(tsch.MetricSmoother(got, gs_t),
                 jsch.MetricSmoother(ref, gs_j), TA, JA, iters=2)


def test_schwarz_scatter_through_the_ghost_slot(bidomain):
    """A colour's blocks share no dof, so only the ghost slot n (the
    padding of every short block) takes duplicate adds; it is dropped,
    and the colour update equals one block solve at a time."""
    TA, _, _, idofs = bidomain
    n = TA.shape[0]
    sm = tss.build_schwarz_fast(TA, idofs, maxlvl=2, mmsize=30,
                                dtype=torch.float64, device=CPU)
    E = ELL.from_host(TA, dtype=torch.float64, device=CPU)
    x, bb = (_t(v) for v in _vecs(n, 7))
    ghost_dups = 0
    for c, ids in enumerate(sm.dof_ids):
        flat = ids.reshape(-1).numpy()
        real = flat[flat < n]
        assert len(np.unique(real)) == len(real), c
        ghost_dups += int(np.sum(flat == n)) - 1
        got = sm._color_update(E, x, bb, c)
        assert got.shape == (n,)
        # one block at a time, on the real dofs only
        ref = x.clone()
        r = bb - E.matvec(x)
        for blk, inv in zip(ids.numpy(), sm.inv_blocks[c]):
            keep = blk < n
            d = inv[keep][:, keep] @ r[blk[keep]]
            ref[blk[keep]] += sm.weight * d
        torch.testing.assert_close(got, ref, rtol=1e-12,
                                   atol=1e-12 * float(ref.abs().max()))
    assert ghost_dups > 0       # the padding did take several adds


# ---------------------------------------------------------------------------
# setup_amg and the cycle
# ---------------------------------------------------------------------------

SETUPS = {
    "metric_mono": ("metric_schwarz", True, "bidomain"),
    "hazmath": ("standard", False, "bidomain"),
    "sa": ("sa_v", False, "poisson"),
}


def _params(key):
    name = SETUPS[key][0]
    if name == "sa_v":
        kw = dict(amg_type="sa", cycle_type="v", aggregation_type="hem",
                  smoother="jacobi")
        return TParams(**kw), AMGParameters(**kw)
    return PRESETS[name], JPRESETS[name]


@pytest.fixture(scope="module")
def setups(poisson, bidomain):
    out = {}
    for key, (_, with_idofs, system) in SETUPS.items():
        TA, JA = (bidomain[:2] if system == "bidomain" else poisson[:2])
        idofs = bidomain[3] if with_idofs else None
        tp, jp = _params(key)
        out[key] = (TA, thier.setup_amg(TA, tp, idofs=idofs, device=CPU),
                    jhier.setup_amg(JA, jp, idofs=idofs))
    return out


@pytest.mark.parametrize("key", list(SETUPS))
def test_setup_amg_levels_match_jax(setups, key):
    TA, got, ref = setups[key]
    assert len(got.levels) == len(ref.levels) >= 1
    for Lg, Lr in zip(got.levels, ref.levels):
        assert Lg.nc == Lr.nc and Lg.A.shape == Lr.A.shape
        _same_csr(Lg.A.to_host(), Lr.A.to_host())
        assert type(Lg.smoother).__name__ == type(Lr.smoother).__name__
        if Lr.agg is not None:
            np.testing.assert_array_equal(Lg.agg.numpy(),
                                          np.asarray(Lr.agg))
        else:
            _same_csr(Lg.P.to_host(), Lr.P.to_host())
            _same_csr(Lg.R.to_host(), Lr.R.to_host())
    cr = np.asarray(ref.coarse_inv)
    np.testing.assert_allclose(got.coarse_inv.numpy(), cr, rtol=1e-12,
                               atol=1e-12 * np.abs(cr).max())
    for f in ("cycle", "maxit", "presmooth", "postsmooth", "amli_degree",
              "max_w_work", "coarse_scaling"):
        assert getattr(got, f) == getattr(ref, f), f


@pytest.mark.parametrize("key", list(SETUPS))
def test_one_cycle_matches_jax(setups, key):
    TA, got, ref = setups[key]
    r = np.random.default_rng(11).standard_normal(TA.shape[0])
    z_ref = np.asarray(ref.matvec(jnp.asarray(r)))
    carried = state.amg_hierarchy_from_jax(ref, device=CPU)
    for prec in (carried, got):
        z = thier.as_operator(prec)(_t(r)).numpy()
        assert np.linalg.norm(z - z_ref) <= 1e-12 * np.linalg.norm(z_ref)
    moved = got.to(CPU)
    assert torch.equal(moved.matvec(_t(r)), got.matvec(_t(r)))


def test_setup_amg_variants_match_jax(bidomain):
    """The HEM/MWM pairwise passes, pad_multiple, float32 storage, the
    stagnation break and the other smoother choices."""
    TA, JA, _, idofs = bidomain
    r = np.random.default_rng(4).standard_normal(TA.shape[0])
    cases = [(dict(aggregation_type="mwm", pairwise_passes=3), {}),
             (dict(smoother="chebyshev", schwarz_levels=1), {}),
             (dict(smoother="l1_jacobi", cycle_type="v", maxit=2), {}),
             (dict(smoother="ssor", aggregation_type="hec",
                   cycle_type="amli"), {}),
             (dict(aggregation_type="mis", cycle_type="add"),
              dict(pad_multiple=8)),
             (dict(coarse_dof=2000), {})]
    for kw, extra in cases:
        tp, jp = TParams(**kw), AMGParameters(**kw)
        got = thier.setup_amg(TA, tp, idofs=idofs, device=CPU, **extra)
        ref = jhier.setup_amg(JA, jp, idofs=idofs, **extra)
        assert [L.nc for L in got.levels] == [L.nc for L in ref.levels], kw
        n = got.levels[0].A.shape[0] if got.levels else TA.shape[0]
        rr = np.zeros(n)
        rr[:len(r)] = r
        z = got.matvec(_t(rr)).numpy()
        zr = np.asarray(ref.matvec(jnp.asarray(rr)))
        assert np.linalg.norm(z - zr) <= 1e-11 * np.linalg.norm(zr), kw
    f32 = thier.setup_amg(TA, TParams(dtype="float32"), device=CPU)
    assert f32.levels[0].A.dtype == torch.float32
    assert f32.coarse_inv.dtype == torch.float32
