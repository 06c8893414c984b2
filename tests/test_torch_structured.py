"""The structured 3D-1D hierarchy of tpuamg_torch against the JAX
package's, on the CPU, at the JAX tests' size (tests/test_3d1d_structured.py:
unit_cube_mesh(6), synthetic_neuron_curve(16, 2), radius 0.2): the slot
orders, the footprint split, the levels of setup_structured, one
preconditioner application per configuration (through the port's own
set-up and through state.structured_hierarchy_from_jax), and the port's
unified structured solves at gamma 1, 1e4 and 1e8 against the JAX test's
bounds.  The JAX side runs with pallas=False, as its own structured tests
do; its applications are eager (about 10 s each here), so each is made
once, in a module fixture."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpuamg.amg import structured as JS
from tpuamg.config import AMGParameters as JP
from tpuamg.fem import unit_cube_mesh
from tpuamg.problems.emi_3d1d import get_system, synthetic_neuron_curve
from tpuamg.sparse.dia import DIA as JDIA
from tpuamg_torch import state
from tpuamg_torch.amg import structured as TS
from tpuamg_torch.config import AMGParameters as TP
from tpuamg_torch.problems import solve as tsolve
from tpuamg_torch.sparse.host import HostCSR

# one preconditioner application, port against JAX (float64); the
# configurations cover the slot orders, both footprint solvers and the
# unified algebraic tail (algebraic_below 300: one window level, then the
# tail on the other 188 dofs)
APPLY = {"morton-exact": ("morton", "exact", 0),
         "hem-exact": ("hem", "exact", 0),
         "tiled-rank1": ("tiled", "rank1", 0),
         "morton-exact-tail": ("morton", "exact", 300)}
# at gamma 1e4 port and JAX applications differ by <= 1.2e-13 (summation
# order); at gamma 1e8 the preconditioner amplifies that to <= 5.6e-10
# (norm-relative), which the gamma-1e8 solve below holds instead
APPLY_GAMMA = 1e4
APPLY_RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread and one BLAS thread: the tier-1
    command's six workers share the host's cores."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _system(gamma, n=6, n_main=16, n_branches=2):
    mesh3d = unit_cube_mesh(n)
    curve = synthetic_neuron_curve(n_main=n_main, n_branches=n_branches)
    A, b, sizes = get_system(mesh3d, curve, k3=3.0,
                             k1=7.0 * np.pi * 0.04,
                             gamma=gamma * 2 * np.pi * 0.2,
                             coupling_radius=0.2)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    return A, b, sizes, coords


def _port(A):
    return HostCSR(np.asarray(A.indptr), np.asarray(A.indices),
                   np.asarray(A.data), A.shape)


def _prm(cls, **kw):
    return cls(cycle_type="v", dtype="float64", schwarz_levels=2, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def sys4():
    A, b, sizes, coords = _system(APPLY_GAMMA)
    idofs = np.arange(sizes[0], sum(sizes))
    return A, _port(A), b, sizes, coords, idofs


@pytest.fixture(scope="module")
def applied(sys4):
    """{config: (JAX prec, port prec, slots, r, JAX z)}: the JAX
    application of each configuration, once."""
    A, At, _, _, coords, idofs = sys4
    out = {}
    for name, (order, fps, ab) in APPLY.items():
        jp, js, jn = JS.setup_structured(
            A, coords, _prm(JP), dtype=jnp.float64, pallas=False,
            idofs=idofs, order=order, fp_solver=fps, algebraic_below=ab)
        tp, ts, tn = TS.setup_structured(
            At, coords, _prm(TP), dtype=torch.float64, pallas=False,
            idofs=idofs, order=order, fp_solver=fps, algebraic_below=ab,
            device="cpu")
        np.testing.assert_array_equal(ts, js)
        assert tn == jn
        r = np.random.default_rng(5).standard_normal(jn)
        out[name] = (jp, tp, r, np.asarray(jp.matvec(jnp.asarray(r))))
    return out


# ---------------------------------------------------------------------------
# slot orders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,keep", [
    ("morton", 0), ("hem", 0), ("hem_banded:8", 0), ("tiled", 0),
    ("auto", 0), ("tiled", 1), ("auto", 2)])
def test_slot_maps_match_jax(sys4, order, keep):
    """setup_structured's slot map and slot count, per order and with
    keep_idofs (aligned idof stride blocks), equal to the JAX package's."""
    A, At, _, _, coords, idofs = sys4
    kw = dict(pallas=False, idofs=idofs, order=order, keep_idofs=keep,
              algebraic_below=100 if keep else 0)
    _, js, jn = JS.setup_structured(A, coords, _prm(JP), dtype=jnp.float64,
                                    **kw)
    tp, ts, tn = TS.setup_structured(At, coords, _prm(TP),
                                     dtype=torch.float64, device="cpu",
                                     **kw)
    np.testing.assert_array_equal(ts, js)
    assert tn == jn
    assert len(np.unique(ts)) == A.shape[0]
    if keep:
        stride = 2 * 4 ** (keep - 1)
        assert np.all(ts[idofs] % stride == 0)
        assert len(tp.fine.levels if hasattr(tp, "fine") else tp.levels) \
            >= 1


def test_slot_helpers_match_jax(sys4):
    """The host helpers one by one: grid spacing, Morton codes, HEM pairs
    (plain and banded), the HEM tree and the tiled lattice at strides
    1/2/8/32."""
    A, At, _, _, coords, idofs = sys4
    for k in range(3):
        assert TS._grid_spacing(coords[:, k]) == \
            JS._grid_spacing(coords[:, k])
    np.testing.assert_array_equal(TS.morton_code(coords),
                                  JS.morton_code(coords))
    np.testing.assert_array_equal(TS._hem_pairs(At, 0.1),
                                  JS._hem_pairs(A, 0.1))
    group = np.arange(A.shape[0]) // 16
    np.testing.assert_array_equal(TS._hem_pairs(At, 0.1, group),
                                  JS._hem_pairs(A, 0.1, group))
    for window in (0, 8):
        t = TS.hem_tree_slots(At, coords, 0.1, window=window)
        j = JS.hem_tree_slots(A, coords, 0.1, window=window)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1] == j[1]
    for stride in (1, 2, 8, 32):
        t = TS.lattice_tiled_slots(coords, idofs, A.shape[0],
                                   idof_stride=stride)
        j = JS.lattice_tiled_slots(coords, idofs, A.shape[0],
                                   idof_stride=stride)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1] == j[1]


def test_off_lattice_bulk(sys4):
    """An off-lattice bulk: lattice_tiled_slots raises ValueError in both
    packages, order 'tiled' raises, 'auto' falls back to Morton (the same
    slots as the JAX package's) and keep_idofs then raises."""
    A, At, _, _, coords, idofs = sys4
    bad = coords.copy()
    bad[:idofs[0]] += 1e-3 * np.random.default_rng(1).standard_normal(
        (idofs[0], 3))
    for f in (TS.lattice_tiled_slots, JS.lattice_tiled_slots):
        with pytest.raises(ValueError):
            f(bad, idofs, A.shape[0])
    with pytest.raises(ValueError):
        TS.setup_structured(At, bad, _prm(TP), dtype=torch.float64,
                            pallas=False, idofs=idofs, order="tiled",
                            device="cpu")
    _, ts, tn = TS.setup_structured(At, bad, _prm(TP), dtype=torch.float64,
                                    pallas=False, idofs=idofs, order="auto",
                                    device="cpu")
    _, js, jn = JS.setup_structured(A, bad, _prm(JP), dtype=jnp.float64,
                                    pallas=False, idofs=idofs, order="auto")
    np.testing.assert_array_equal(ts, js)
    with pytest.raises(ValueError, match="keep_idofs"):
        TS.setup_structured(At, bad, _prm(TP), dtype=torch.float64,
                            pallas=False, idofs=idofs, order="auto",
                            keep_idofs=1, algebraic_below=100,
                            device="cpu")


# ---------------------------------------------------------------------------
# the footprint operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 8])
def test_split_footprint_matches_jax(sys4, cap):
    """split_footprint_operator uncapped and with a cap small enough to
    spill: the same DIA part, blocks, block matrices and spill; and the
    StructuredOp's matvec/residual equal A's (1e-12)."""
    A, At, b, sizes, _, idofs = sys4
    tb = TS._neighbor_blocks(At, idofs)
    jb = JS._neighbor_blocks(A, idofs)
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t, j)
    T = TS.split_footprint_operator(At, tb, max_offsets=cap)
    J = JS.split_footprint_operator(A, jb, max_offsets=cap)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(T[0], f), getattr(J[0], f))
    np.testing.assert_array_equal(T[1], J[1])
    np.testing.assert_array_equal(T[2], J[2])
    assert (T[3] is None) == (J[3] is None) == (cap is None)
    if cap is not None:
        for t, j in zip(T[3], J[3]):
            np.testing.assert_array_equal(t, j)
    op = TS._structured_op(T[0], T[1], T[2], T[3], At.nnz, torch.float64,
                           False, torch.device("cpu"))
    if cap is not None:
        assert len(op.dia.offsets) <= cap + 1
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    ref = A.matvec(x)
    assert _rel(op.matvec(xt).numpy(), ref) <= 1e-12
    assert _rel(op.residual(xt, bt).numpy(), b - ref) <= 1e-12
    jop = JS.StructuredOp(
        JDIA.from_host(J[0], dtype=jnp.float64), jnp.asarray(J[1]),
        jnp.asarray(J[2]), nnz=A.nnz,
        spill=None if J[3] is None else tuple(jnp.asarray(a)
                                              for a in J[3]))
    assert _rel(op.matvec(xt).numpy(), np.asarray(jop.matvec(
        jnp.asarray(x)))) <= 1e-12


# ---------------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------------

def _dense_of(op):
    """A level operator of either package (DIA, KernelDIA or StructuredOp)
    as a dense f64 array, from its parts: the DIA part's to_host, the
    footprint blocks and the spill."""
    def arr(t):
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    dia = getattr(op, "dia", op)
    out = dia.to_host().toarray().astype(np.float64)
    if hasattr(op, "ids"):
        n = out.shape[0]
        big = np.zeros((n + 1, n + 1))
        big[:n, :n] = out
        ids, mats = arr(op.ids).astype(np.int64), arr(op.mats)
        for k in range(len(ids)):
            big[np.ix_(ids[k], ids[k])] += mats[k]
        out = big[:n, :n]
        if op.spill is not None:
            r, c, v = (arr(a) for a in op.spill)
            np.add.at(out, (r.astype(np.int64), c.astype(np.int64)), v)
    return out


@pytest.mark.parametrize("name", list(APPLY))
def test_levels_match_jax(applied, name):
    """Every level: the operator (f64, to 1e-12), mask, s, n_groups, nc,
    the Chebyshev interval and block inverses, the Schwarz colors."""
    jp, tp, _, _ = applied[name]
    assert len(tp.levels) == len(jp.levels)
    for L, J in zip(tp.levels, jp.levels):
        if not hasattr(J, "n_groups"):          # algebraic tail level
            np.testing.assert_allclose(L.A.to_host().toarray(),
                                       J.A.to_host().toarray(), rtol=0,
                                       atol=1e-12 * np.abs(
                                           J.A.to_host().data).max())
            continue
        assert (L.s, L.n_groups, L.nc) == (J.s, J.n_groups, J.nc)
        np.testing.assert_array_equal(L.mask.numpy(), np.asarray(J.mask))
        assert _rel(_dense_of(L.A), _dense_of(J.A)) <= 1e-12
        sm, jsm = L.smoother, J.smoother
        if hasattr(jsm, "schwarz"):
            assert len(sm.schwarz.dof_ids) == len(jsm.schwarz.dof_ids)
            for a, c in zip(sm.schwarz.dof_ids, jsm.schwarz.dof_ids):
                np.testing.assert_array_equal(a.numpy(), np.asarray(c))
            sm, jsm = sm.cheb, jsm.cheb
        assert (sm.lmax, sm.lmin) == (jsm.lmax, jsm.lmin)
        assert _rel(sm.blockinv.numpy(), np.asarray(jsm.blockinv)) <= 1e-12


@pytest.mark.parametrize("name", list(APPLY))
def test_application_matches_jax(applied, name):
    """One preconditioner application on the same r, the port's own
    set-up and the JAX data through structured_hierarchy_from_jax, to
    APPLY_RTOL of the JAX application."""
    jp, tp, r, zj = applied[name]
    rt = torch.as_tensor(r)
    assert _rel(tp.matvec(rt).numpy(), zj) <= APPLY_RTOL
    fj = state.structured_hierarchy_from_jax(jp, "cpu")
    assert _rel(fj.matvec(rt).numpy(), zj) <= APPLY_RTOL
    if APPLY[name][2]:
        assert any(type(L).__name__ == "MGLevel" for L in tp.levels)


@pytest.mark.parametrize("gamma", [1e0, 1e4, 1e8])
def test_unified_structured_solve(gamma):
    """tests/test_3d1d_structured.py::test_3d1d_structured_gamma_robust's
    configuration through the port's solve_system: converged in <= 40
    iterations.  The true residual: < 1e-7 at gamma 1 and 1e4, the JAX
    test's bound.  At gamma 1e8 the crossing iterate (stop type 2, tol
    1e-8, 18 iterations) reads 4.9e-7 in both packages (the JAX package
    with chunk=1: 4.93e-7); the JAX test's 1e-7 holds there only for its
    chunk-end iterate (2.96e-8, 14 iterations past the crossing), so the
    gamma-1e8 case is held to the JAX crossing iterate in
    tests/test_torch_host_tail.py::test_unified_solve_matches_jax and
    here to 1e-6."""
    A, b, sizes, coords = _system(gamma)
    At = _port(A)
    idofs = np.arange(sizes[0], sum(sizes))
    rep = tsolve.solve_system(At, b, "metric_mono", sizes, params=_prm(TP),
                              tol=1e-8, maxiter=150,
                              structured_coords=coords, idofs=idofs,
                              pallas=False, device="cpu")
    assert rep.converged and rep.niters <= 40, (gamma, rep.niters)
    assert rep.route == "structured"
    rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert rel < (1e-6 if gamma == 1e8 else 1e-7), (gamma, rel)


def test_unported_fp_solvers_raise(sys4):
    """rank1g (DiagRank1Smoother) and deflate are not ported: ValueError
    naming ROADMAP item 13."""
    A, At, b, sizes, coords, idofs = sys4
    for fps in ("rank1g", "deflate"):
        with pytest.raises(ValueError, match="item 13"):
            tsolve.solve_system(At, b, "metric_mono", sizes,
                                params=_prm(TP), structured_coords=coords,
                                idofs=idofs, pallas=False, fp_solver=fps,
                                device="cpu")
    with pytest.raises(ValueError, match="item 13"):
        TS.setup_structured(At, coords, _prm(TP), dtype=torch.float64,
                            idofs=idofs, fp_solver="rank1g", device="cpu")


def test_kernel_classes_on_window_levels(sys4):
    """float32 with the kernel classes (pallas None, on the CPU their plain
    versions): footprint levels hold a StructuredOp over a KernelDIA; with
    the footprint gate off (schwarz_levels 0) the window levels take
    FusedChebSmoother where A and C have at most kernels.MAX_DIAGS bands
    and DiaChebyshevSmoother with KernelDIA A and C otherwise; the cycle
    matches the float64 plain one to float32 accuracy."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (FusedChebSmoother,
                                                 KernelDIA)
    A, At, _, _, coords, idofs = sys4
    tp, _, n = TS.setup_structured(At, coords, _prm(TP, coarse_dof=50),
                                   dtype=torch.float32, idofs=idofs,
                                   device="cpu")
    assert isinstance(tp.levels[0].A, TS.StructuredOp)
    assert isinstance(tp.levels[0].A.dia, KernelDIA)
    prm0 = TP(cycle_type="v", dtype="float32", schwarz_levels=0,
              coarse_dof=20)
    for order in ("morton", "hem"):
        tk, _, n = TS.setup_structured(At, coords, prm0,
                                       dtype=torch.float32, idofs=idofs,
                                       order=order, device="cpu")
        t64, _, _ = TS.setup_structured(At, coords, prm0,
                                        dtype=torch.float64, idofs=idofs,
                                        order=order, device="cpu")
        for L in tk.levels:
            assert isinstance(L.A, KernelDIA)
            wide = len(L.A.offsets) > kernels.MAX_DIAGS
            assert isinstance(L.smoother, TS.DiaChebyshevSmoother
                              if wide else FusedChebSmoother)
            if wide:
                assert isinstance(L.smoother.C, KernelDIA)
        r = np.random.default_rng(3).standard_normal(n)
        z32 = tk.matvec(torch.as_tensor(r, dtype=torch.float32)).double()
        z64 = t64.matvec(torch.as_tensor(r))
        assert _rel(z32.numpy(), z64.numpy()) <= 1e-3
    assert any(len(L.A.offsets) > kernels.MAX_DIAGS
               for L in tk.levels)      # hem: a band count past 64
