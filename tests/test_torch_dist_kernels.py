"""The distributed layer's kernels' plain versions
(tpuamg_torch.dist.dist_kernels), K7's counterpart and the padding
helpers of tpuamg_torch.dist.solve against the JAX package.

* cheb_step_plain over eight in-process halo'd shards, and
  ShardedChebSmoother on a one-rank gloo group, against
  tpuamg.amg.structured.BlockChebyshevSmoother on the inputs of
  tests/test_dist_pallas.py:66-93 (n = 128*8*8, F = 2, mask tail zero,
  degree 3, iters 2): 1e-5 on x, 1e-4 on the residual.
* ShardedPDIA's and ShardedDIA's plain paths, and dia_spmv_pallas's
  counterpart on 1024-aligned and on arbitrary offsets, against
  tpuamg.sparse.dia.DIA.matvec / residual: 1e-6.
* pad_grid_problem, unpad_grid_vector and _dist_pallas_mults against the
  JAX functions, exactly, on tests/test_dist_pallas.py:96-124's cases.
* Where the JAX kernels' layout cannot be met (n=4), the solve pads as
  the JAX package then does and keeps the port's kernel classes.

Multi-rank runs are in tests/test_torch_dist.py.
"""
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from tpuamg.amg.structured import BlockChebyshevSmoother as JBlockCheb
from tpuamg.sparse.dia import DIA as JDIA
from tpuamg_torch.dist import dist_kernels as dk
from tpuamg_torch.dist import solve as tds
from tpuamg_torch.dist.sharding import device_mesh
from tpuamg_torch.sparse.dia import DIA
from tpuamg_torch.sparse.dia_kernels import (_cheb_coefs, blockinv_dia,
                                             dia_spmv_pallas,
                                             dia_spmv_plain)

NDEV = 8


def _banded(n, offsets, seed=0, dd=4.0):
    """tests/test_dist_pallas.py's random banded DIA planes (float64)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n))
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = rng.standard_normal(hi - lo) * 0.1
    data[offsets.index(0), :] += dd
    return data


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group for the classes that exchange halos."""
    started = not dist.is_initialized()
    m = device_mesh("cpu")
    yield m
    if started:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cheb_case():
    """The inputs of tests/test_dist_pallas.py::
    test_sharded_cheb_matches_block_smoother, and the JAX results."""
    F = 2
    n = 128 * 8 * NDEV
    offsets = [-128, -2, -1, 0, 1, 2, 128]
    data = _banded(n, offsets, seed=2).astype(np.float32)
    A = JDIA(offsets, jnp.asarray(data), (n, n))
    rng = np.random.default_rng(3)
    blockinv = np.linalg.inv(
        rng.standard_normal((n // F, F, F)) * 0.1 + 2 * np.eye(F))
    mask = np.ones(n)
    mask[-7:] = 0.0
    lmax, lmin = 2.5, 0.3
    ref = JBlockCheb(jnp.asarray(blockinv, dtype=jnp.float32),
                     jnp.asarray(mask, dtype=jnp.float32), lmax, lmin, 3)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    y2 = np.asarray(ref.smooth(A, jnp.asarray(x), jnp.asarray(b), iters=2))
    y1 = np.asarray(ref.smooth(A, jnp.asarray(x), jnp.asarray(b), iters=1))
    r1 = b - np.asarray(A.matvec(jnp.asarray(y1)))
    return dict(F=F, n=n, offsets=offsets, data=data, blockinv=blockinv,
                mask=mask, lmax=lmax, lmin=lmin, x=x, b=b, y2=y2, y1=y1,
                r1=r1)


def _shard_sweep(c, iters, want_r):
    """The sharded smoother's arithmetic on NDEV in-process shards: each
    step's x halos sliced from the whole iterate (zeros at the ends), one
    cheb_step_plain per shard."""
    n, F, offs = c["n"], c["F"], tuple(c["offsets"])
    nl, h = n // NDEV, max(abs(o) for o in offs)
    offsC, cdata = blockinv_dia(c["blockinv"], c["mask"])
    pA = torch.as_tensor(c["data"])
    pC = torch.as_tensor(cdata, dtype=torch.float32)
    theta, coefs = _cheb_coefs(c["lmax"], c["lmin"], 3)
    steps = [(True, 1.0 / theta, 0.0)] + [(False, a, cc) for a, cc in coefs]
    rows = [slice(r * nl, (r + 1) * nl) for r in range(NDEV)]
    b = torch.as_tensor(c["b"])
    x = torch.as_tensor(c["x"])
    d = [torch.zeros(nl) for _ in rows]
    for _ in range(iters):
        for first, s, cc in steps:
            xhs = dk.halo_shards(x, h, NDEV)
            x = torch.cat([dk.cheb_step_plain(
                offs, pA[:, sl], offsC, pC[:, sl], xhs[r], h, b[sl], d[r],
                first, s, cc, d_out=d[r])[0] for r, sl in enumerate(rows)])
    r = None
    if want_r:
        r = torch.cat([dia_spmv_plain(offs, pA[:, sl], xh, b[sl], x_pad=h)
                       for sl, xh in zip(rows, dk.halo_shards(x, h, NDEV))])
    return x, r


def test_cheb_step_shards_match_block_smoother(cheb_case):
    c = cheb_case
    y2, _ = _shard_sweep(c, 2, False)
    assert _rel(y2, c["y2"]) < 1e-5
    y1, r1 = _shard_sweep(c, 1, True)
    assert _rel(y1, c["y1"]) < 1e-5
    assert _rel(r1, c["r1"]) < 1e-4


def test_sharded_cheb_smoother_matches_block_smoother(cheb_case, mesh):
    c = cheb_case
    A = dk.ShardedDIA(c["offsets"], torch.as_tensor(c["data"]),
                      (c["n"], c["n"]), 0, mesh)
    sm = dk.ShardedChebSmoother.build(A, c["blockinv"], c["mask"],
                                      c["lmax"], c["lmin"], 3, mesh)
    x, b = torch.as_tensor(c["x"]), torch.as_tensor(c["b"])
    assert _rel(sm.smooth(None, x, b, iters=2), c["y2"]) < 1e-5
    y1, r1 = sm.smooth_residual(None, x, b, iters=1)
    assert _rel(y1, c["y1"]) < 1e-5
    assert _rel(r1, c["r1"]) < 1e-4
    # the caller's x is left as it was
    assert torch.equal(x, torch.as_tensor(c["x"]))


def test_sharded_cheb_smoother_layout_checks(mesh):
    """Node blocks must not straddle a shard edge; the halo may be any
    width (tests/test_torch_dist.py runs halos wider than a shard)."""
    A = dk.ShardedDIA((-1, 0, 1), torch.ones(3, 63), (63, 63), 0, mesh)
    with pytest.raises(ValueError, match="straddle"):
        dk.ShardedChebSmoother.build(A, np.ones((31, 2, 2)), np.ones(63),
                                     2.0, 0.2, 3, mesh)
    n = 64
    A = dk.ShardedDIA((-70, 0, 70), torch.ones(3, n), (n, n), 0, mesh)
    sm = dk.ShardedChebSmoother.build(A, np.ones((n, 1, 1)), np.ones(n),
                                      2.0, 0.2, 3, mesh)
    assert sm.h == 70 > sm.n
    with pytest.raises(ValueError, match="divisible"):
        dk.ShardedPDIA.from_dia(DIA((0,), torch.ones(1, 63), (63, 63)),
                                SimpleNamespace(rank=0, size=2))


@pytest.fixture(scope="module")
def spmv_case():
    """tests/test_dist_pallas.py::test_sharded_pdia_matches_dia's DIA."""
    n = 128 * 8 * NDEV * 2
    offsets = [-130, -128, -3, -1, 0, 1, 3, 128, 130]
    data = _banded(n, offsets, seed=0).astype(np.float32)
    A = JDIA(offsets, jnp.asarray(data), (n, n))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return dict(n=n, offsets=offsets, data=data, x=x, b=b,
                y=np.asarray(A.matvec(jnp.asarray(x))),
                r=np.asarray(A.residual(jnp.asarray(x), jnp.asarray(b))))


@pytest.mark.parametrize("cls", [dk.ShardedPDIA, dk.ShardedDIA])
def test_sharded_pdia_matches_dia(spmv_case, mesh, cls):
    c = spmv_case
    A = cls.from_dia(DIA(c["offsets"], torch.as_tensor(c["data"]),
                         (c["n"],) * 2), mesh)
    x, b = torch.as_tensor(c["x"]), torch.as_tensor(c["b"])
    assert _rel(A.matvec(x), c["y"]) < 1e-6
    assert _rel(A.residual(x, b), c["r"]) < 1e-6
    assert float(A.dots((x, b))[0]) == pytest.approx(
        float(np.dot(c["x"].astype(np.float64), c["b"])), rel=1e-5)


def test_sharded_pdia_shards_match_dia(spmv_case):
    """The padded-x sweep of each of NDEV in-process shards."""
    c = spmv_case
    n, offs = c["n"], tuple(c["offsets"])
    h, nl = max(abs(o) for o in offs), n // NDEV
    pA = torch.as_tensor(c["data"])
    xhs = dk.halo_shards(torch.as_tensor(c["x"]), h, NDEV)
    b = torch.as_tensor(c["b"])
    y = torch.cat([dia_spmv_plain(offs, pA[:, r * nl:(r + 1) * nl], xh,
                                  x_pad=h) for r, xh in enumerate(xhs)])
    r = torch.cat([dia_spmv_plain(offs, pA[:, r * nl:(r + 1) * nl], xh,
                                  b[r * nl:(r + 1) * nl], x_pad=h)
                   for r, xh in enumerate(xhs)])
    assert _rel(y, c["y"]) < 1e-6
    assert _rel(r, c["r"]) < 1e-6


@pytest.mark.parametrize("offsets", [
    [-2048, -1024, 0, 1024, 3072],          # the JAX kernel's alignment
    [-1155, -130, -3, -1, 0, 1, 3, 127, 1026, 1155],      # any offsets
])
def test_dia_spmv_pallas_counterpart_matches_dia(offsets):
    n = 8192 * 2 + 77
    data = _banded(n, offsets, seed=4).astype(np.float32)
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    y_ref = np.asarray(JDIA(offsets, jnp.asarray(data), (n, n)).matvec(
        jnp.asarray(x)))
    y = dia_spmv_pallas(DIA(offsets, torch.as_tensor(data), (n, n)),
                        torch.as_tensor(x), block=8192)
    assert y.shape == (n,)
    assert _rel(y, y_ref) < 1e-6


def test_padded_sweep_equals_unpadded_sweep():
    """x_pad = p over a zero-padded x gives the unpadded sweep's bits."""
    rng = np.random.default_rng(6)
    n, offs = 3000, (-700, -5, 0, 2, 900)
    planes = torch.as_tensor(rng.standard_normal((len(offs), n)))
    x = torch.as_tensor(rng.standard_normal(n))
    b = torch.as_tensor(rng.standard_normal(n))
    for p in (0, 1, 700, 1000):
        xp = torch.zeros(n + 2 * p, dtype=x.dtype)
        xp[p:p + n] = x
        assert torch.equal(dia_spmv_plain(offs, planes, xp, x_pad=p),
                           dia_spmv_plain(offs, planes, x))
        assert torch.equal(dia_spmv_plain(offs, planes, xp, b, x_pad=p),
                           dia_spmv_plain(offs, planes, x, b))


def test_pad_grid_problem_matches_jax():
    from tpuamg.dist.solve import pad_grid_problem, unpad_grid_vector
    from tpuamg.fem import mms as jmms
    from tpuamg.problems.bidomain import (Params, get_mesh as jget_mesh,
                                          get_system as jget_system)
    p = Params(2.0, 3.0, 1e4)
    A, b, _, _ = jget_system(jget_mesh(12, 2), jmms.setup_bidomain_mms(p, 2),
                             p)
    from tpuamg_torch.sparse import HostCSR
    At = HostCSR(A.indptr, A.indices, A.data, A.shape)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    for mult in ((16, 8), 16, 1):
        J = pad_grid_problem(A, b, (13, 13), 2, mult)
        T = tds.pad_grid_problem(At, b, (13, 13), 2, mult)
        for a in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(T[0], a), getattr(J[0], a)), a
        assert T[0].shape == J[0].shape
        assert np.array_equal(T[1], J[1])
        assert T[2] == J[2]
        assert np.array_equal(T[3], J[3])
        xb = tds.pad_grid_problem(At, x, (13, 13), 2, mult)[1]
        assert np.array_equal(tds.unpad_grid_vector(xb, (13, 13), T[2], 2),
                              unpad_grid_vector(xb, (13, 13), J[2], 2))
    assert T[2] == (13, 13)


@pytest.mark.parametrize("dims,F", [((17, 17), 2), ((513, 513), 2),
                                    ((9, 9, 9), 2), ((33, 65), 1),
                                    ((65, 65), 2)])
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_dist_pallas_mults_match_jax(dims, F, ndev):
    from tpuamg.dist.solve import _dist_pallas_mults
    for kw in (dict(), dict(pallas_levels=1)):
        assert tds._dist_pallas_mults(dims, F, ndev, 3, **kw) == \
            _dist_pallas_mults(dims, F, ndev, 3, **kw)


def test_kernel_classes_stay_where_the_jax_layout_fails(mesh):
    """At n=4 no padding meets the JAX kernels' 1024-row layout within its
    cap: the grid is padded as without kernels (axis 0 to 8), and the
    port keeps K6 and the padded-x SpMV, which need no layout."""
    from tpuamg_torch.config import AMGParameters
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, 1e6)
    A, b, _, _ = get_system(get_mesh(4, 2), mms.setup_bidomain_mms(p, 2), p)
    with pytest.raises(ValueError):
        tds._dist_pallas_mults((5, 5), 2, 1, 3, pallas_levels=1)
    prm = AMGParameters(cycle_type="v", coarse_dof=10, dtype="float32")
    res, _ = tds.distributed_grid_solve(A, b, (5, 5), F=2, params=prm,
                                        mesh=mesh, tol=1e-6, maxiter=60)
    info = res.dist_info
    assert info["nflat"] == 8 * 5 * 2
    assert info["outer_pallas"] and info["sharded_levels"] > 0
    assert info["pallas_levels"] == info["sharded_levels"]
    assert res.converged
    assert _rel(A.matvec(res.x), b) < 1e-5
