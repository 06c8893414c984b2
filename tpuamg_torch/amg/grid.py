"""Host helpers of the grid-structured hierarchy (copies).

The parts of the JAX package's ``amg/grid.py`` that the fused hierarchy
(``amg/grid_fused.py``) builds on: the per-node field interleave, the
Galerkin window-coarse operator, and the power-iteration bound of the
block-Jacobi-preconditioned operator (same seed, so the Chebyshev
interval matches).  ``setup_grid``/``grid_system`` are not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..sparse import HostCSR


def interleave_fields(nv, F):
    """slots[f*nv + v] = v*F + f — per-node field interleave."""
    v = np.arange(nv)
    slots = np.empty(nv * F, dtype=np.int64)
    for f in range(F):
        slots[f * nv:(f + 1) * nv] = v * F + f
    return slots


def _grid_coarse(A: HostCSR, mask, dims, F):
    """Galerkin window-coarse operator: aggregate = (2^d grid-cell window,
    field) — the field axis is preserved.  Masked rows excluded; empty
    aggregates become identity rows with mask 0."""
    d = len(dims)
    cdims = tuple((x + 1) // 2 for x in dims)
    n = A.shape[0]
    idx = np.arange(n)
    f = idx % F
    node = idx // F
    coords = []
    rem = node
    for ax in reversed(range(d)):
        coords.append(rem % dims[ax])
        rem //= dims[ax]
    coords = coords[::-1]                   # coords[ax]
    cnode = 0
    for ax in range(d):
        cnode = cnode * cdims[ax] + coords[ax] // 2
    agg = cnode * F + f
    r, c, v = A.to_coo()
    real = (mask[r] > 0) & (mask[c] > 0)
    nc = int(np.prod(cdims)) * F
    sums = np.bincount(agg, weights=mask, minlength=nc)
    mask_c = (sums > 0).astype(np.float64)
    dead = np.flatnonzero(mask_c == 0)
    Ac = HostCSR.from_coo(
        np.concatenate([agg[r[real]], dead]),
        np.concatenate([agg[c[real]], dead]),
        np.concatenate([v[real], np.ones(len(dead))]), (nc, nc))
    return Ac, mask_c, cdims


def _lmax_blockinv(A: HostCSR, apply_binv, mask, iters=15, seed=0):
    """Power-iteration estimate of lambda_max(B^-1 A) on the masked
    space, from the same seeded start vector as the JAX package."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0]) * mask
    lam = 1.0
    for _ in range(iters):
        y = apply_binv(A.matvec(x)) * mask
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)
