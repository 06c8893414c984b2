"""K1's wide entry on the CPU: the tile-compacted layout
(tpuamg_torch.sparse.dia_tiles) and its plain walk against
dia_spmv_plain (bit for bit: the same products, added per row in the
same order) and against the JAX package's DIA SpMV (its plain reference,
DIA.matvec, and PDIA in interpret mode for one case), for y = A x and
b - A x with float32 and bfloat16 planes; the builder's per-tile band
lists against a numpy count; and the structured 3D-1D route's AD built by
both packages at tests/test_torch_structured.py's sizes."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuamg.sparse.dia import DIA as JDIA
from tpuamg.sparse.dia_pallas import PDIA
from tpuamg_torch import kernels
from tpuamg_torch.sparse import dia_tiles
from tpuamg_torch.sparse.dia_kernels import KernelDIA, dia_spmv_plain
from tpuamg_torch.sparse.dia_tiles import build_tiles, dia_tiles_plain

# float32 sums in another order (XLA against torch): relative 1e-6 of the
# largest entry
JAX_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the tier-1 command's six workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_offsets(rng, nd, span):
    return np.sort(rng.choice(np.arange(-span, span + 1), nd,
                              replace=False))


def _case(name):
    """(offsets, planes (nd, n) float64) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("random"):
        nd = int(name[6:])
        n = {65: 1000, 700: 2000, 3000: 4000}[nd]
        offs = _rand_offsets(rng, nd, 3 * n // 2)     # some beyond +-n
        dens = {65: 0.3, 700: 0.05, 3000: 0.01}[nd]
        P = rng.standard_normal((nd, n)) * (rng.random((nd, n)) < dens)
    elif name == "empty":       # empty rows, all-zero tiles and a zero band
        n, nd = 999, 80
        offs = _rand_offsets(rng, nd, 300)
        P = rng.standard_normal((nd, n)) * (rng.random((nd, n)) < 0.2)
        P[:, 100:101] = 0.0
        P[:, 320:450] = 0.0
        P[7] = 0.0
    elif name == "beyond":      # bands that reach no column at all
        n, nd = 300, 70
        offs = np.concatenate([[-2 * n, -n - 5, -n, n, n + 5, 2 * n],
                               _rand_offsets(rng, nd - 6, n - 1)])
        offs = np.sort(offs)
        P = rng.standard_normal((nd, n))
    elif name.startswith("dense"):  # every tile has all nd bands
        nd = int(name[5:])
        n = 1000
        offs = np.arange(-(nd // 2), nd - nd // 2)
        P = rng.standard_normal((nd, n))
    else:
        raise KeyError(name)
    return tuple(int(o) for o in offs), P


CASES = ("random65", "random700", "random3000", "empty", "beyond",
         "dense256", "dense300")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _planes(P, dt):
    return torch.as_tensor(P, dtype=torch.float32).to(dt)


def _jax_planes(planes):
    """The same stored values as a JAX array of the same dtype."""
    if planes.dtype == torch.bfloat16:
        return jnp.asarray(planes.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(planes.numpy())


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_walk_matches_plain_and_jax(case, dt):
    offs, P = _case(case)
    planes = _planes(P, DTYPES[dt][0])
    nd, n = planes.shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    tiles = build_tiles(offs, planes)
    J = JDIA(offs, _jax_planes(planes), (n, n))
    for rhs, rhs_t in ((None, None), (b, bt)):
        y = dia_tiles_plain(tiles, xt, rhs_t)
        assert y.dtype == torch.float32
        assert torch.equal(y, dia_spmv_plain(offs, planes, xt, rhs_t))
        ref = J.matvec(jnp.asarray(x)) if rhs is None else \
            J.residual(jnp.asarray(x), jnp.asarray(rhs))
        assert _rel(y.numpy(), ref) < JAX_RTOL, (case, dt, rhs is None)
    # KernelDIA on CPU tensors walks the same layout
    K = KernelDIA(offs, planes, (n, n), 0)
    assert torch.equal(K.residual(xt, bt), dia_tiles_plain(tiles, xt, bt))
    assert K.tiles() is K.tiles()


def test_walk_matches_pdia_interpret():
    """65 bands through the JAX package's Pallas SpMV and residual in
    interpret mode, as its own tests run them on the CPU."""
    offs, P = _case("random65")
    planes = _planes(P, torch.float32)
    n = planes.shape[1]
    pd = PDIA.from_dia(JDIA(offs, jnp.asarray(planes.numpy()), (n, n)),
                       interpret=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    K = KernelDIA(offs, planes, (n, n), 0)
    y = K.matvec(torch.from_numpy(x)).numpy()
    assert _rel(y, pd.matvec(jnp.asarray(x))) < JAX_RTOL
    r = K.residual(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    assert _rel(r, pd.residual(jnp.asarray(x), jnp.asarray(b))) < JAX_RTOL


def _numpy_layout(offs, P, T):
    """Per tile, the stored-order indices of the bands with a nonzero in
    range; per row, its nonzero (band, value) list."""
    nd, n = P.shape
    i = np.arange(n)
    live = np.zeros((nd, n), dtype=bool)
    for d, o in enumerate(offs):
        live[d] = (P[d] != 0) & (i + o >= 0) & (i + o < n)
    tiles = [np.flatnonzero(live[:, t * T:(t + 1) * T].any(1))
             for t in range(-(-n // T))]
    rows = [np.flatnonzero(live[:, r]) for r in range(n)]
    return tiles, rows


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("case", CASES)
def test_tile_band_lists_match_numpy(case, rows):
    """The builder's per-tile band lists (as offsets, in stored order),
    each row's entries (local index -> band, value) in stored order with
    zero padding, the index width rule, and the nonzero count."""
    offs, P = _case(case)
    planes = _planes(P, torch.float32)
    Pf = planes.double().numpy()
    tiles = build_tiles(offs, planes, rows)
    ref_tiles, ref_rows = _numpy_layout(offs, Pf, rows)
    off = np.asarray(offs)
    bp = tiles.band_ptr.numpy()
    tile_off = tiles.tile_off.numpy()
    assert len(bp) == len(ref_tiles) + 1
    for t, bands in enumerate(ref_tiles):
        np.testing.assert_array_equal(tile_off[bp[t]:bp[t + 1]], off[bands])
    most = max(len(bands) for bands in ref_tiles)
    assert tiles.max_bands == most
    assert tiles.idx.dtype == (torch.uint8 if most <= 256 else torch.int16)
    assert tiles.nnz == sum(len(r) for r in ref_rows)
    ep = tiles.ent_ptr.numpy()
    vals = tiles.vals.double().numpy()
    idx = tiles.idx.numpy().astype(np.int64) & 0xFFFF
    G = dia_tiles.GROUP
    for r, bands in enumerate(ref_rows):
        t, lane = divmod(r, rows)
        W = (ep[t + 1] - ep[t]) // rows
        assert W % G == 0 and W >= len(bands)
        k = np.arange(W)
        pos = ep[t] + ((k // G) * rows + lane) * G + k % G
        local = np.searchsorted(ref_tiles[t], bands)
        np.testing.assert_array_equal(idx[pos[:len(bands)]], local)
        np.testing.assert_array_equal(vals[pos[:len(bands)]],
                                      Pf[bands, r])
        assert not vals[pos[len(bands):]].any()


def test_layout_limits_and_stale_planes(monkeypatch):
    """A tile of more bands than the uint16 indices hold cannot be built
    (ValueError); KernelDIA builds its layout again when its planes are
    written in place or replaced, and walks the new operator; at most
    MAX_DIAGS bands have no layout."""
    offs, P = _case("dense300")
    planes = _planes(P, torch.float32)
    n = planes.shape[1]
    monkeypatch.setattr(dia_tiles, "MAX_UINT16_BANDS", 299)
    with pytest.raises(ValueError, match="300 bands"):
        build_tiles(offs, planes)
    monkeypatch.undo()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)
                         .astype(np.float32))
    K = KernelDIA(offs, planes, (n, n), 0)
    tiles = K.tiles()
    assert tiles.fresh(planes) and not tiles.fresh(planes.clone())
    planes[:, ::3] = 0.0
    assert not tiles.fresh(planes)
    y = K.matvec(x)
    assert K.tiles() is not tiles and K.tiles().fresh(planes)
    assert torch.equal(y, dia_spmv_plain(offs, planes, x))
    K.planes = planes.clone()
    assert torch.equal(K.matvec(x), y) and K.tiles().planes is K.planes
    assert KernelDIA(offs[:64], planes[:64], (n, n), 0).tiles() is None
    with pytest.raises(ValueError, match="must be positive"):
        build_tiles(offs, planes, 0)
    with pytest.raises(ValueError, match="offsets for"):
        build_tiles(offs[:-1], planes)


def test_cpu_builds_are_not_counted():
    """A layout built for CPU tensors launches nothing and counts no
    build (the count is the card's)."""
    offs, P = _case("random65")
    planes = _planes(P, torch.float32)
    n = planes.shape[1]
    kernels.reset_launches()
    KernelDIA(offs, planes, (n, n), 0).matvec(torch.zeros(n))
    assert not any(kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The structured route's AD, through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[6, 8])
def structured_ad(request):
    """(JAX AD DIA, port AD KernelDIA) of the factored outer operator at
    unit_cube_mesh(mesh_n), synthetic_neuron_curve(16, 2), radius 0.2
    (tests/test_torch_structured.py's system), in the tiled slot order,
    float32 storage, built by each package from the same host matrices."""
    from tpuamg.amg.structured import lattice_tiled_slots
    from tpuamg.fem import unit_cube_mesh
    from tpuamg.problems.emi_3d1d import get_system, synthetic_neuron_curve
    from tpuamg.problems.solve import _split_metric_operator as j_split
    from tpuamg_torch.problems.solve import _split_metric_operator as t_split
    from tpuamg_torch.sparse.host import HostCSR
    mesh3d = unit_cube_mesh(request.param)
    curve = synthetic_neuron_curve(n_main=16, n_branches=2)
    g = 1e4 * 2 * np.pi * 0.2
    A, _, sizes, (Pi, Mq) = get_system(
        mesh3d, curve, k3=3.0, k1=7.0 * np.pi * 0.04, gamma=g,
        coupling_radius=0.2, return_coupling=True)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    idofs = np.arange(sizes[0], sum(sizes))
    slots, nsl = lattice_tiled_slots(coords, idofs, A.shape[0])

    def port(M):
        return HostCSR(np.asarray(M.indptr), np.asarray(M.indices),
                       np.asarray(M.data), M.shape)
    jop = j_split(A, (g, Pi, Mq), sizes, slots, nsl, jnp.float32, False)
    top = t_split(port(A), (g, port(Pi), port(Mq)), sizes, slots, nsl,
                  torch.float32, None, "cpu")
    return jop.args[0][0], top.AD


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_structured_ad_walk_matches_jax(structured_ad, dt):
    """The port's AD is a wide KernelDIA with the JAX AD's offsets and
    planes; its walk (in float32 and in bfloat16 storage) equals
    dia_spmv_plain bit for bit and the JAX DIA's matvec and residual to
    1e-6."""
    JA, TA = structured_ad
    assert isinstance(TA, KernelDIA)
    assert TA.offsets == JA.offsets and len(TA.offsets) > kernels.MAX_DIAGS
    np.testing.assert_array_equal(TA.planes.numpy(), np.asarray(JA.data))
    tdt, jdt = DTYPES[dt]
    planes = TA.planes.to(tdt)
    K = KernelDIA(TA.offsets, planes, TA.shape, TA.nnz)
    J = JDIA(JA.offsets, JA.data.astype(jdt), JA.shape)
    n = TA.shape[0]
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    y = K.matvec(xt)
    assert torch.equal(y, dia_spmv_plain(K.offsets, planes, xt))
    assert _rel(y.numpy(), J.matvec(jnp.asarray(x))) < JAX_RTOL
    r = K.residual(xt, bt)
    assert torch.equal(r, dia_spmv_plain(K.offsets, planes, xt, bt))
    assert _rel(r.numpy(), J.residual(jnp.asarray(x), jnp.asarray(b))) \
        < JAX_RTOL
    tiles = K.tiles()
    assert tiles.nnz == int((planes != 0).sum()) - sum(
        int((planes[d, :max(0, -o)] != 0).sum()
            + (planes[d, min(n, n - o):] != 0).sum())
        for d, o in enumerate(K.offsets))
