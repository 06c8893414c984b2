"""The unfused grid path of tpuamg_torch against the JAX package.

* FusedChebSmoother (the plain version of kernel K3 on the CPU) against
  the JAX FusedChebSmoother in interpret mode, at the shapes of
  tests/test_pallas.py::test_fused_cheb_smoother_matches_reference, and
  against the port's op-by-op BlockChebyshevSmoother.
* One application of MGPreconditioner (V, W, NL-AMLI) on the hierarchy of
  the JAX package's amg.grid.setup_grid, carried across by
  tpuamg_torch.state: f64 with plain ops (rtol 1e-10) and f32 with the
  JAX kernels in interpret mode (rtol 2e-5 at gamma 1; at gamma 1e6,
  where f32 rounding alone moves a cycle by O(1e-5), within twice the
  JAX f32 cycle's own distance from the f64 one).  The other cycles
  (AMLI, additive, FMG with V and with W inner cycles) and coarse
  scaling, in f64 with plain ops (rtol 1e-10).
* The port's own setup_grid against the JAX one, array for array.

The JAX interpret runs are slow, so each runs once, in a module fixture.
"""
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from tpuamg.config import PRESETS
from tpuamg.fem import mms
from tpuamg.problems.bidomain import Params, get_mesh, get_system
from tpuamg.sparse import HostCSR as JHostCSR
from tpuamg.sparse.dia import DIA as JDIA
from tpuamg_torch import state
from tpuamg_torch.amg import grid as tgrid
from tpuamg_torch.amg.structured import (BlockChebyshevSmoother,
                                         DiaChebyshevSmoother)
from tpuamg_torch.sparse import HostCSR
from tpuamg_torch.sparse.dia import DIA
from tpuamg_torch.sparse.dia_kernels import (FusedChebSmoother, KernelDIA,
                                             blockinv_dia)

# ---------------------------------------------------------------------------
# K3's plain version against the JAX kernel
# ---------------------------------------------------------------------------

N_CHEB = 700
LMAX, LMIN, DEGREE = 1.8, 0.22, 4


def _cheb_problem():
    """tests/test_pallas.py's SPD-ified random DIA with its 2x2 block
    inverses, and the inputs, from numpy seeds."""
    rng = np.random.default_rng(11)
    n = N_CHEB
    rows, cols, vals = [], [], []
    for o in (-52, -2, 0, 2, 52):
        r = np.arange(max(0, -o), min(n, n - o))
        rows.append(r)
        cols.append(r + o)
        vals.append(rng.standard_normal(len(r)))
    arr = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                np.concatenate(cols))),
                        shape=(n, n)).toarray()
    arr = arr + np.diag(np.abs(arr).sum(1) + 1.0)
    Asp = sp.csr_matrix(arr)
    F = 2
    blocks = np.stack([arr[g * F:(g + 1) * F, g * F:(g + 1) * F]
                       for g in range(n // F)])
    blockinv = np.linalg.inv(blocks)
    coffs, cdata = blockinv_dia(blockinv, np.ones(n))
    rng = np.random.default_rng(10)
    x0 = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return Asp, blockinv, coffs, cdata, x0, b


@pytest.fixture(scope="module")
def cheb():
    from tpuamg.sparse.dia_pallas import FusedChebSmoother as JFused
    Asp, blockinv, coffs, cdata, x0, b = _cheb_problem()
    n = N_CHEB
    JA = JDIA.from_host(JHostCSR(Asp.indptr, Asp.indices, Asp.data,
                                 Asp.shape))
    JC = JDIA(coffs, jnp.asarray(cdata, jnp.float32), (n, n))
    jsm = JFused.build(JA, JC, LMAX, LMIN, degree=DEGREE, interpret=True)
    xj, bj = jnp.asarray(x0), jnp.asarray(b)
    ref = {it: np.asarray(jsm.smooth(None, xj, bj, it)) for it in (1, 2)}
    xr, rr = jsm.smooth_residual(None, xj, bj, 1)
    ref["xr"], ref["r"] = np.asarray(xr), np.asarray(rr)
    A = HostCSR(Asp.indptr, Asp.indices, Asp.data, Asp.shape)
    AD = DIA.from_host(A, dtype=torch.float32, device="cpu")
    C = DIA(coffs, torch.as_tensor(cdata, dtype=torch.float32), (n, n))
    sm = FusedChebSmoother.build(AD, C, LMAX, LMIN, degree=DEGREE)
    return dict(ref=ref, sm=sm, AD=AD, C=C, blockinv=blockinv, cdata=cdata,
                x0=torch.as_tensor(x0), b=torch.as_tensor(b), Asp=Asp)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("iters", [1, 2])
def test_fused_cheb_smooth_matches_jax_kernel(cheb, iters):
    y = cheb["sm"].smooth(None, cheb["x0"], cheb["b"], iters)
    assert _rel(y, cheb["ref"][iters]) < 2e-5


def test_fused_cheb_smooth_residual_matches_jax_kernel(cheb):
    x, r = cheb["sm"].smooth_residual(None, cheb["x0"], cheb["b"], 1)
    assert _rel(x, cheb["ref"]["xr"]) < 2e-5
    assert _rel(r, cheb["ref"]["r"]) < 2e-5
    # r is exactly the residual of the returned x
    np.testing.assert_allclose(
        r.numpy(), cheb["b"].numpy() - cheb["AD"].matvec(x).numpy(),
        rtol=0, atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("iters", [1, 2])
def test_fused_cheb_matches_block_chebyshev(cheb, iters):
    """K3's plain sweep computes BlockChebyshevSmoother's (and
    DiaChebyshevSmoother's) function: f64 op-by-op cross-check."""
    n = N_CHEB
    A64 = DIA.from_host(HostCSR(cheb["Asp"].indptr, cheb["Asp"].indices,
                                cheb["Asp"].data, cheb["Asp"].shape),
                        dtype=torch.float64, device="cpu")
    blk = BlockChebyshevSmoother(torch.as_tensor(cheb["blockinv"]),
                                 torch.ones(n, dtype=torch.float64),
                                 LMAX, LMIN, DEGREE)
    dia = DiaChebyshevSmoother(DIA(cheb["C"].offsets,
                                   torch.as_tensor(cheb["cdata"]), (n, n)),
                               LMAX, LMIN, DEGREE)
    x64, b64 = cheb["x0"].double(), cheb["b"].double()
    y_blk = blk.smooth(A64, x64, b64, iters)
    y_dia = dia.smooth(A64, x64, b64, iters)
    np.testing.assert_allclose(y_dia.numpy(), y_blk.numpy(), rtol=1e-12,
                               atol=1e-12)
    y = cheb["sm"].smooth(None, cheb["x0"], cheb["b"], iters)
    assert _rel(y, y_blk) < 2e-5


def test_fused_cheb_zero_sweeps_is_identity(cheb):
    x, r = cheb["sm"].smooth_residual(None, cheb["x0"], cheb["b"], 0)
    np.testing.assert_array_equal(x.numpy(), cheb["x0"].numpy())
    assert _rel(r, cheb["b"] - cheb["AD"].matvec(cheb["x0"])) < 1e-6


# ---------------------------------------------------------------------------
# MGPreconditioner on the JAX package's setup_grid hierarchy
# ---------------------------------------------------------------------------

CYCLES = ("v", "w", "nl_amli")
# the cycles that route (c) alone runs, checked in f64 (plain JAX ops)
CYCLES64 = ("amli", "add", "fmg", "fmg_w")


def _bidomain(gamma=1e6, n=16):
    p = Params(2.0, 3.0, gamma)
    A, b, sizes, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2),
                                p)
    return A, b


def _prm(cycle, dtype):
    return replace(PRESETS["metric_schwarz"], cycle_type=cycle,
                   amli_degree=2, dtype=dtype)


@pytest.fixture(scope="module")
def grids():
    """JAX setup_grid hierarchies and one application each on the same
    vector: f64 plain at gamma 1e6 (every cycle), f32 interpret at gamma 1
    and 1e6 (V, W, NL-AMLI)."""
    from tpuamg.amg.grid import setup_grid as jax_setup_grid
    out = {}
    for gamma in (1.0, 1e6):
        A, _ = _bidomain(gamma)
        r = np.random.default_rng(7).standard_normal(A.shape[0])
        for cycle in CYCLES + CYCLES64:
            for dt, jdt, pallas in (("float64", jnp.float64, False),
                                    ("float32", jnp.float32, "interpret")):
                if dt == "float64" and gamma != 1e6:
                    continue
                if dt == "float32" and cycle in CYCLES64:
                    continue
                prec, slots, n = jax_setup_grid(A, (17, 17), F=2,
                                                params=_prm(cycle, dt),
                                                dtype=jdt, pallas=pallas)
                # r is a vector in the interleaved order
                z = np.asarray(prec.matvec(jnp.asarray(r, dtype=jdt)))
                out[cycle, dt, gamma] = (A, prec, r, z)
    return out


def _apply(prec, r, dt):
    return prec.matvec(torch.as_tensor(r, dtype=getattr(torch, dt)))


@pytest.mark.parametrize("cycle", CYCLES)
@pytest.mark.parametrize("dt,gamma,rtol", [("float64", 1e6, 1e-10),
                                           ("float32", 1.0, 2e-5)])
def test_mg_apply_matches_jax(grids, cycle, dt, gamma, rtol):
    _, prec, r, z_ref = grids[cycle, dt, gamma]
    tp = state.grid_hierarchy_from_jax(prec, device="cpu")
    if dt == "float32":
        # the JAX interpret hierarchy carries kernel classes: so does ours
        assert isinstance(tp.levels[0].A, KernelDIA)
        assert isinstance(tp.levels[0].smoother, FusedChebSmoother)
    z = _apply(tp, r, dt)
    assert z.dtype == getattr(torch, dt)
    assert _rel(z, z_ref) < rtol


@pytest.mark.parametrize("cycle", CYCLES64)
def test_mg_apply_other_cycles_match_jax(grids, cycle):
    """AMLI, additive and FMG (V and W inner cycles): route (c) alone runs
    them.  f64, plain ops in both packages."""
    _, prec, r, z_ref = grids[cycle, "float64", 1e6]
    tp = state.grid_hierarchy_from_jax(prec, device="cpu")
    assert tp.cycle == cycle
    z = _apply(tp, r, "float64")
    assert z.dtype == torch.float64
    assert _rel(z, z_ref) < 1e-10


@pytest.mark.parametrize("cycle", ("v", "w", "nl_amli", "fmg"))
def test_mg_coarse_scaling_matches_jax(grids, cycle):
    """coarse_scaling=True (pinned off on the grid path, ported with its
    JAX formula) on the same f64 levels in both packages."""
    from tpuamg.amg.hierarchy import MGPreconditioner as JMG
    from tpuamg_torch.amg.hierarchy import MGPreconditioner
    _, prec, r, z_off = grids[cycle, "float64", 1e6]
    settings = dict(cycle=prec.cycle, maxit=prec.maxit,
                    presmooth=prec.presmooth, postsmooth=prec.postsmooth,
                    amli_degree=prec.amli_degree,
                    max_w_work=prec.max_w_work, coarse_scaling=True)
    jprec = JMG(prec.levels, prec.coarse_inv, **settings)
    z_ref = np.asarray(jprec.matvec(jnp.asarray(r)))
    # the scaling changes the cycle: the comparison is not vacuous
    assert _rel(z_ref, z_off) > 1e-6
    tp = state.grid_hierarchy_from_jax(prec, device="cpu")
    ts = MGPreconditioner(tp.levels, tp.coarse_inv, **settings)
    assert _rel(_apply(ts, r, "float64"), z_ref) < 1e-10


@pytest.mark.parametrize("cycle", CYCLES)
def test_mg_apply_f32_gamma_1e6_within_f32_floor(grids, cycle):
    """At gamma 1e6 two f32 cycles differ by their rounding, O(1e-5) (the
    JAX package's own interpret and plain f32 cycles differ by 2-4e-5
    here): the port's f32 cycle is held to the f64 cycle with the bound
    the JAX f32 interpret cycle meets, doubled."""
    _, prec32, r, z32 = grids[cycle, "float32", 1e6]
    _, _, _, z64 = grids[cycle, "float64", 1e6]
    z = _apply(state.grid_hierarchy_from_jax(prec32, device="cpu"), r,
               "float32")
    floor = _rel(z32, z64)
    assert floor < 1e-4
    assert _rel(z, z64) <= 2 * floor


@pytest.mark.parametrize("cycle", CYCLES)
@pytest.mark.parametrize("dt,gamma", [("float64", 1e6), ("float32", 1.0)])
def test_own_setup_grid_matches_jax(grids, cycle, dt, gamma):
    """The port's setup_grid builds the JAX hierarchy: the same level
    operators, masks, dims, Chebyshev intervals and coarse inverse, and
    the same classes by the same dtype rule (f32 -> kernel classes)."""
    _check_own_setup_grid(grids, cycle, dt, gamma)


@pytest.mark.parametrize("cycle", CYCLES64)
def test_own_setup_grid_other_cycles_match_jax(grids, cycle):
    """The same for the cycles that only route (c) runs (f64)."""
    _check_own_setup_grid(grids, cycle, "float64", 1e6)


def _check_own_setup_grid(grids, cycle, dt, gamma):
    A, prec, r, z_ref = grids[cycle, dt, gamma]
    tdt = getattr(torch, dt)
    own, slots, n = tgrid.setup_grid(A, (17, 17), F=2,
                                     params=_prm(cycle, dt), dtype=tdt,
                                     device="cpu")
    carried = state.grid_hierarchy_from_jax(prec, device="cpu")
    assert len(own.levels) == len(carried.levels)
    assert (own.cycle, own.amli_degree, own.max_w_work) == \
        (carried.cycle, carried.amli_degree, carried.max_w_work)
    for La, Lb in zip(own.levels, carried.levels):
        assert type(La.A) is type(Lb.A)
        assert type(La.smoother) is type(Lb.smoother)
        assert La.dims == Lb.dims and La.nc == Lb.nc
        assert La.A.offsets == Lb.A.offsets
        pa = getattr(La.A, "planes", getattr(La.A, "data", None))
        pb = getattr(Lb.A, "planes", getattr(Lb.A, "data", None))
        np.testing.assert_allclose(pa.double().numpy(),
                                   pb.double().numpy(), rtol=1e-12)
        np.testing.assert_array_equal(La.mask.numpy(), Lb.mask.numpy())
        np.testing.assert_allclose(La.smoother.lmax, Lb.smoother.lmax,
                                   rtol=1e-10)
    np.testing.assert_allclose(own.coarse_inv.double().numpy(),
                               carried.coarse_inv.double().numpy(),
                               rtol=1e-6, atol=1e-12)
    z = own.matvec(torch.as_tensor(r, dtype=tdt))
    assert _rel(z, z_ref) < (1e-10 if dt == "float64" else 2e-5)


def test_grid_level_transfers_match_jax():
    """Restriction pads odd axes, prolongation crops; R = P^T."""
    from tpuamg.amg.grid import GridLevel as JLevel
    dims, F = (5, 7), 2
    n = int(np.prod(dims)) * F
    rng = np.random.default_rng(5)
    mask = (rng.random(n) > 0.2).astype(np.float64)
    r = rng.standard_normal(n)
    jl = JLevel(None, None, jnp.asarray(mask), dims, F)
    tl = tgrid.GridLevel(None, None, torch.as_tensor(mask), dims, F)
    rc = tl.restrict(torch.as_tensor(r))
    np.testing.assert_allclose(rc.numpy(), np.asarray(jl.restrict(
        jnp.asarray(r))), rtol=1e-14)
    e = rng.standard_normal(tl.nc)
    pe = tl.prolong(torch.as_tensor(e))
    np.testing.assert_allclose(pe.numpy(), np.asarray(jl.prolong(
        jnp.asarray(e))), rtol=1e-14)
    assert abs(float(torch.dot(pe, torch.as_tensor(r)))
               - float(torch.dot(torch.as_tensor(e), rc))) < 1e-10


@pytest.mark.parametrize("pallas,dtype,kernel_classes", [
    (None, torch.float32, True),
    (True, torch.float32, True),
    (False, torch.float32, False),
    (None, torch.bfloat16, True),
    (None, torch.float64, False),
])
def test_kernel_rule(pallas, dtype, kernel_classes):
    """The JAX package's resolve_pallas rule on its accelerator; the
    card's presence plays no part."""
    assert tgrid.use_kernels(pallas, dtype) is kernel_classes


def test_kernels_forced_on_f64_data_raise():
    """pallas=True with f64 data raises rather than run the plain classes
    under the kernels' name; setup_grid and grid_system pass it on."""
    with pytest.raises(ValueError, match="float64"):
        tgrid.use_kernels(True, torch.float64)
    A = HostCSR.from_coo(np.arange(4), np.arange(4), np.ones(4), (4, 4))
    with pytest.raises(ValueError):
        tgrid.setup_grid(A, (2, 2), F=1, dtype=torch.float64, pallas=True,
                         device="cpu")
    with pytest.raises(ValueError):
        tgrid.grid_system(A, np.arange(4), dtype=torch.float64, pallas=True,
                          device="cpu")


# ---------------------------------------------------------------------------
# setup_grid_fused(reference=True): the fused cycle's own f64 reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cycle,rtol", [("v", 2e-5), ("w", 8e-5)])
def test_fused_reference_matches_jax_and_cycle(cycle, rtol):
    """The port's reference MGPreconditioner on the padded canonical
    hierarchy equals the JAX package's (f64, rtol 1e-10), and the port's
    fused cycle (plain version, f32) matches it with the tolerances of
    tests/test_grid_fused.py (8e-5 for W, as test_fused_w_matches_reference
    _2d allows)."""
    from tpuamg.amg.grid_fused import setup_grid_fused as jax_setup
    from tpuamg_torch.amg.grid_fused import setup_grid_fused
    from tpuamg_torch.amg.hierarchy import MGPreconditioner
    A, _ = _bidomain(1e6)
    prm = replace(PRESETS["metric_schwarz"], cycle_type=cycle,
                  coarse_dof=60, dtype="float32")
    vc, slots, nflat, ref, slots_can = setup_grid_fused(
        A, (17, 17), F=2, params=prm, cheb_degree=3, device="cpu",
        reference=True)
    assert isinstance(ref, MGPreconditioner)
    _, jslots, _, jref, jslots_can = jax_setup(
        A, (17, 17), F=2, params=prm, cheb_degree=3, interpret=True,
        reference=True)
    np.testing.assert_array_equal(slots, jslots)
    np.testing.assert_array_equal(slots_can, jslots_can)
    r = np.random.default_rng(3).standard_normal(A.shape[0])
    n0 = ref.levels[0].A.shape[0]
    rcan = np.zeros(n0)
    rcan[slots_can] = r
    z_ref = ref.matvec(torch.as_tensor(rcan)).numpy()[slots_can]
    z_jax = np.asarray(jref.matvec(jnp.asarray(rcan)))[slots_can]
    assert _rel(z_ref, z_jax) < 1e-10
    bk = torch.zeros(nflat)
    bk[torch.as_tensor(slots)] = torch.as_tensor(r, dtype=torch.float32)
    z = vc.matvec(bk).numpy()[slots]
    assert _rel(z, z_ref) < rtol
