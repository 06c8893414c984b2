"""K1's plain version (tpuamg_torch.sparse.dia_kernels) against the JAX
package's PDIA kernels run in interpret mode, on the same planes; plus the
op-level DIA and the copied host helpers."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuamg.sparse import HostCSR
from tpuamg.sparse.dia import DIA as JDIA
from tpuamg.sparse.dia_pallas import (PDIA, blockinv_dia as j_blockinv,
                                      _cheb_coefs as j_coefs)
from tpuamg_torch import state
from tpuamg_torch.sparse import HostCSR as TCSR
from tpuamg_torch.sparse.dia import DIA, dia_matvec_op
from tpuamg_torch.sparse.dia_kernels import (KernelDIA, blockinv_dia,
                                             _cheb_coefs, dia_spmv)

# the fused grid's level-0 offsets at n=512 reach +-1155 (9 rows of 128)
OFFS = [-1155, -1153, -1027, -130, -128, -3, -1, 0, 1, 3, 128, 130, 1027,
        1153, 1155]


def _random_dia(n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for o in offsets:
        r = np.arange(max(0, -o), min(n, n - o))
        rows.append(r)
        cols.append(r + o)
        vals.append(rng.standard_normal(len(r)))
    return HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals), (n, n))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("storage", [jnp.float32, jnp.bfloat16])
def test_plain_k1_matches_pdia_interpret(storage):
    """f32 sums in another order: 1e-6 relative to the largest entry."""
    n = 5000
    A = _random_dia(n, OFFS, seed=1)
    P = PDIA.from_dia(JDIA.from_host(A, dtype=storage), interpret=True)
    K = state.kernel_dia_from_jax(P, device="cpu")
    assert K.planes.dtype == (torch.float32 if storage == jnp.float32
                              else torch.bfloat16)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    y_j = np.asarray(P.matvec(jnp.asarray(x)))
    y_t = K.matvec(torch.from_numpy(x)).numpy()
    assert y_t.dtype == np.float32
    assert _rel(y_t, y_j) < 1e-6
    r_j = np.asarray(P.residual(jnp.asarray(x), jnp.asarray(b)))
    r_t = K.residual(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    assert _rel(r_t, r_j) < 1e-6


def test_kernel_dia_from_host_matches_dia_and_scipy_oracle():
    n = 1500
    offsets = [-130, -128, -127, -1, 0, 1, 127, 128, 130]
    A = _random_dia(n, offsets, seed=3)
    At = TCSR(A.indptr, A.indices, A.data, A.shape)
    x = np.random.default_rng(4).standard_normal(n)
    ref = A.matvec(x)
    D = DIA.from_host(At, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(dia_matvec_op(D)(torch.from_numpy(x)).numpy(),
                               ref, rtol=1e-12, atol=1e-12)
    K = KernelDIA.from_host(At, dtype=torch.float32, device="cpu")
    y = K.matvec(torch.from_numpy(x.astype(np.float32))).numpy()
    np.testing.assert_allclose(y, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(K.to_host().toarray(), A.toarray(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(K.diagonal().numpy(),
                                  np.float32(A.diagonal()))


def test_dia_spmv_offsets_beyond_n_and_out_buffer():
    n = 100
    planes = torch.ones((3, n))
    x = torch.arange(n, dtype=torch.float32)
    out = torch.empty(n)
    y = dia_spmv((-200, 0, 150), planes, x, out=out)
    assert y is out
    torch.testing.assert_close(y, x)


def test_host_helpers_are_copies():
    rng = np.random.default_rng(5)
    bi = rng.standard_normal((30, 2, 2))
    mask = (rng.random(60) > 0.2).astype(float)
    to, td = blockinv_dia(bi, mask)
    jo, jd = j_blockinv(bi, mask)
    assert list(to) == list(jo)
    np.testing.assert_array_equal(td, jd)
    for kind in (1, 4):
        assert _cheb_coefs(2.3, 0.3, 4, kind) == j_coefs(2.3, 0.3, 4, kind)
