"""Quadrature rules on reference simplices (barycentric form).

Each rule returns (bary, weights): bary (nq, d+1) barycentric coordinates,
weights (nq,) summing to 1 (i.e. normalized by simplex measure).
Used for load vectors, boundary integrals and error norms — the quadrature
counterpart of DOLFIN's assemble/errornorm machinery (SURVEY.md §2b) with
degree-4+ accuracy matching the reference's `degree=4` expressions
(reference bidomain_2d.py:35).
"""
from __future__ import annotations

import numpy as np


def _gauss_legendre_01(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def interval_rule(degree):
    n = max(1, (degree + 2) // 2)
    x, w = _gauss_legendre_01(n)
    bary = np.stack([1 - x, x], axis=1)
    return bary, w


def triangle_rule(degree):
    """Collapsed-product (Duffy) Gauss rule on the reference triangle —
    exact to `degree`, a few more points than optimal symmetric rules."""
    n = max(1, (degree + 2) // 2) + 1
    x, wx = _gauss_legendre_01(n)
    y, wy = _gauss_legendre_01(n)
    X, Y = np.meshgrid(x, y, indexing="ij")
    WX, WY = np.meshgrid(wx, wy, indexing="ij")
    u = X.ravel()
    v = (Y * (1 - X)).ravel()
    # dA = (1-u) du dv ; total = 1/2 (ref triangle area); normalize to sum 1
    w = (WX.ravel() * WY.ravel() * (1 - u))
    w = w / w.sum()
    bary = np.stack([1 - u - v, u, v], axis=1)
    return bary, w


def tet_rule(degree):
    n = max(1, (degree + 2) // 2) + 1
    x, wx = _gauss_legendre_01(n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    WX, WY, WZ = np.meshgrid(wx, wx, wx, indexing="ij")
    # Duffy for tet: (x, y(1-x), z(1-x)(1-y))
    u = X.ravel()
    v = (Y * (1 - X)).ravel()
    t = (Z * (1 - X) * (1 - Y)).ravel()
    w = (WX * WY * WZ * (1 - X) ** 2 * (1 - Y)).ravel()
    w = w / w.sum()
    bary = np.stack([1 - u - v - t, u, v, t], axis=1)
    return bary, w


def simplex_rule(tdim, degree):
    if tdim == 1:
        return interval_rule(degree)
    if tdim == 2:
        return triangle_rule(degree)
    if tdim == 3:
        return tet_rule(degree)
    raise ValueError(tdim)


def vertex_rule(tdim):
    """Barycentric rule with points at vertices (for P1 interpolation)."""
    d = tdim + 1
    return np.eye(d), np.full(d, 1.0 / d)
