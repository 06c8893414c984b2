"""Host layer of tpuamg_torch against the JAX package: the numpy sparse
toolkit, the manufactured solution (autodiff in torch vs in JAX) and the
assembled bidomain system."""
import numpy as np
import pytest

from tpuamg.fem import mms as jmms
from tpuamg.problems import bidomain as jbid
from tpuamg.sparse import HostCSR as JCSR, bmat as jbmat, rap as jrap
from tpuamg_torch.fem import mms as tmms
from tpuamg_torch.problems import bidomain as tbid
from tpuamg_torch.sparse import HostCSR as TCSR, bmat as tbmat, rap as trap


def _coo(n, m, nnz, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, nnz), rng.integers(0, m, nnz),
            rng.standard_normal(nnz))


def _same(a, b, tol=1e-12):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=tol, atol=tol)


@pytest.mark.parametrize("nnz", [50, 20_000])   # both sides of the JAX
def test_hostcsr_from_coo_matches(nnz):        # package's native cutoff
    r, c, v = _coo(300, 200, nnz, 0)
    _same(TCSR.from_coo(r, c, v, (300, 200)),
          JCSR.from_coo(r, c, v, (300, 200)))


def test_hostcsr_bmat_rap_elimination_match():
    mats = [(_coo(40, 40, 200, s)) for s in range(4)]
    T = [TCSR.from_coo(*m, (40, 40)) for m in mats]
    J = [JCSR.from_coo(*m, (40, 40)) for m in mats]
    _same(tbmat([[T[0], T[1]], [None, T[2]]]),
          jbmat([[J[0], J[1]], [None, J[2]]]))
    _same(trap(T[3].T, T[0], T[3]), jrap(J[3].T, J[0], J[3]))
    dofs = np.array([0, 5, 17, 39])
    ta, tc = T[1].eliminate_rows_cols(dofs)
    ja, jc = J[1].eliminate_rows_cols(dofs)
    _same(ta, ja)
    _same(tc, jc)
    x = np.random.default_rng(9).standard_normal(40)
    np.testing.assert_allclose(T[2].matvec(x), J[2].matvec(x), rtol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_mms_matches_jax_autodiff(dim):
    p = jbid.Params(2.0, 3.0, 1e6)
    jd = jmms.setup_bidomain_mms(p, dim)
    td = tmms.setup_bidomain_mms(p, dim)
    pts = np.random.default_rng(dim).random((257, dim))
    for key in ("u1", "u2", "grad_u1", "grad_u2", "flux1", "flux2", "f1",
                "f2"):
        a, b = td[key](pts), jd[key](pts)
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max(), err_msg=key)


@pytest.mark.parametrize("gamma", [1.0, 1e6])
def test_bidomain_2d_system_matches(gamma):
    p = jbid.Params(2.0, 3.0, gamma)
    JA, jb, js, jbc = jbid.get_system(jbid.get_mesh(16, 2),
                                      jmms.setup_bidomain_mms(p, 2), p)
    TA, tb, ts, tbc = tbid.get_system(tbid.get_mesh(16, 2),
                                      tmms.setup_bidomain_mms(p, 2), p)
    assert ts == js
    np.testing.assert_array_equal(tbc, jbc)
    _same(TA, JA)
    np.testing.assert_allclose(tb, jb, rtol=1e-12,
                               atol=1e-12 * np.abs(jb).max())


def test_bidomain_3d_system_matches():
    p = jbid.Params(2.0, 3.0, 1e6)
    JA, jb, _, _ = jbid.get_system(jbid.get_mesh(4, 3),
                                   jmms.setup_bidomain_mms(p, 3), p)
    TA, tb, _, _ = tbid.get_system(tbid.get_mesh(4, 3),
                                   tmms.setup_bidomain_mms(p, 3), p)
    _same(TA, JA)
    np.testing.assert_allclose(tb, jb, rtol=1e-12,
                               atol=1e-12 * np.abs(jb).max())
