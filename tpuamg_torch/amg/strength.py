"""Strength-of-connection graphs for aggregation AMG.

Copy of the JAX package's ``amg/strength.py``: HAZmath's strength
computation configured by ``strong_coupled`` (reference
amg_parameters.py:17,60): |a_ij| >= theta * sqrt(|a_ii a_jj|) on the
symmetrized matrix.  Host-side numpy, fully vectorized.
"""
from __future__ import annotations

import numpy as np

from ..sparse.host import HostCSR


def strength_graph(A: HostCSR, theta=0.1) -> HostCSR:
    """Symmetric strength graph: keep off-diagonal (i,j) with
    |a_ij| >= theta * sqrt(|a_ii a_jj|); values = |a_ij| (edge weights for
    matching). Diagonal excluded."""
    r, c, v = A.to_coo()
    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    off = r != c
    w = np.abs(v)
    strong = off & (w >= theta * np.sqrt(d[r] * d[c]))
    S = HostCSR.from_coo(r[strong], c[strong], w[strong], A.shape)
    # symmetrize (max of both directions)
    St = S.T
    rs, cs, vs = S.to_coo()
    rt, ct, vt = St.to_coo()
    allr = np.concatenate([rs, rt])
    allc = np.concatenate([cs, ct])
    allv = np.concatenate([vs, vt])
    # max-coalesce: sort and take max per (r,c)
    order = np.lexsort((allc, allr))
    allr, allc, allv = allr[order], allc[order], allv[order]
    if len(allr):
        new = np.empty(len(allr), dtype=bool)
        new[0] = True
        new[1:] = (allr[1:] != allr[:-1]) | (allc[1:] != allc[:-1])
        gid = np.cumsum(new) - 1
        mx = np.zeros(gid[-1] + 1)
        np.maximum.at(mx, gid, allv)
        starts = np.flatnonzero(new)
        return HostCSR.from_coo(allr[starts], allc[starts], mx, A.shape,
                                sum_duplicates=False)
    return S
