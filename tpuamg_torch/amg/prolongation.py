"""Tentative and smoothed prolongators (host setup).

Copy of the JAX package's ``amg/prolongation.py``: HAZmath's UA/SA
prolongator construction (``AMG_type`` UA/SA, reference
amg_parameters.py:5, input_metric.dat:68):
- UA (unsmoothed aggregation): piecewise-constant tentative P, columns the
  aggregates (near-null space = constants for these scalar elliptic blocks);
- SA (smoothed aggregation): P = (I - omega D^{-1} A_f) P_tent with the
  filtered matrix A_f and omega = damp / rho(D^{-1} A_f); Galerkin RAP via
  SpGEMM.
"""
from __future__ import annotations

import numpy as np

from ..sparse.host import HostCSR
from ..smoothers.relaxation import estimate_lmax_dinv_a


def tentative_prolongator(agg, nagg, normalize=False) -> HostCSR:
    n = len(agg)
    rows = np.flatnonzero(agg >= 0)
    cols = agg[rows]
    vals = np.ones(len(rows))
    if normalize:
        counts = np.bincount(cols, minlength=nagg).astype(np.float64)
        vals = 1.0 / np.sqrt(counts[cols])
    return HostCSR.from_coo(rows, cols, vals, (n, nagg),
                            sum_duplicates=False)


def filtered_matrix(A: HostCSR, theta=0.1) -> HostCSR:
    """Drop weak off-diagonal entries, lumping them onto the diagonal
    (standard SA filtering)."""
    r, c, v = A.to_coo()
    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    off = r != c
    weak = off & (np.abs(v) < theta * np.sqrt(d[r] * d[c]))
    keep = ~weak
    # lump dropped values onto the diagonal
    lump = np.zeros(A.shape[0])
    np.add.at(lump, r[weak], v[weak])
    diag_rows = np.arange(A.shape[0])
    return HostCSR.from_coo(
        np.concatenate([r[keep], diag_rows]),
        np.concatenate([c[keep], diag_rows]),
        np.concatenate([v[keep], lump]), A.shape)


def smoothed_prolongator(A: HostCSR, P_tent: HostCSR, theta=0.1,
                         damp=4.0 / 3.0) -> HostCSR:
    # The prolongator-smoothing filter needs a positive threshold even when
    # the aggregation strength threshold is 0 ("everything is strong"):
    # smoothing P with an unfiltered operator that has near-dense rows
    # (e.g. cylinder-average coupling, emi_3d1d) wrecks the Galerkin coarse
    # operator (measured: cond 1e5 vs 1e2 on the 3D-1D system).
    Af = filtered_matrix(A, max(theta, 0.05))
    lmax = max(estimate_lmax_dinv_a(Af), 1e-12)
    omega = damp / lmax
    d = Af.diagonal()
    d = np.where(np.abs(d) > 0, d, 1.0)
    DinvA = Af.scale_rows(1.0 / d)
    return P_tent.add(DinvA.matmat(P_tent), alpha=1.0, beta=-omega)
