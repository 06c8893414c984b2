"""Non-matching-dimension coupling operators: 3D->1D cylinder average and
trace (copy of the JAX package's ``fem/coupling.py``, host numpy).

Rebuilds the xii operators used by the reduced EMI neuron problem
(SURVEY.md §2b "FEniCS_ii"): ``Average(u, meshQ, Circle(radius, degree))``
(reference emi_3d1d.py:65-68) degenerating to a 3D->1D trace at
radius=0, realized as an explicit sparse matrix Pi: for each 1D-mesh vertex,
P1-interpolate the 3D field at quadrature points on the circle of the given
radius centered at the vertex in the plane normal to the local curve
tangent, and average.  Host-side geometric code (point location in tets via
uniform-grid binning), producing a HostCSR consumed by assembly.
"""
from __future__ import annotations

import numpy as np

from ..sparse import HostCSR
from .mesh import Mesh


class TetLocator:
    """Uniform-grid point location in a tet (or triangle) mesh."""

    def __init__(self, mesh: Mesh, bins_per_axis=None):
        self.mesh = mesh
        X = mesh.cell_coords()                       # (nc, d+1, g)
        d = mesh.gdim
        nc = mesh.num_cells
        ones = np.ones((nc, d + 1, 1))
        A = np.concatenate([ones, X], axis=2)
        self.Tinv = np.linalg.inv(A)                 # bary = Tinv^T @ [1; x]
        self.lo = X.min(axis=1)                      # (nc, g)
        self.hi = X.max(axis=1)
        gmin = self.lo.min(axis=0)
        gmax = self.hi.max(axis=0)
        self.gmin = gmin
        span = np.where(gmax - gmin > 0, gmax - gmin, 1.0)
        if bins_per_axis is None:
            bins_per_axis = max(2, int(np.ceil(nc ** (1.0 / d) / 2)))
        self.nb = bins_per_axis
        self.h = span / self.nb
        # bin ranges per cell
        blo = np.clip(((self.lo - gmin) / self.h).astype(np.int64), 0,
                      self.nb - 1)
        bhi = np.clip(((self.hi - gmin) / self.h).astype(np.int64), 0,
                      self.nb - 1)
        self.bins = {}
        for c in range(nc):
            rng = [range(blo[c, k], bhi[c, k] + 1) for k in range(d)]
            if d == 3:
                for i in rng[0]:
                    for j in rng[1]:
                        for k in rng[2]:
                            self.bins.setdefault((i, j, k), []).append(c)
            else:
                for i in rng[0]:
                    for j in rng[1]:
                        self.bins.setdefault((i, j), []).append(c)

    def locate(self, pts, eps=1e-10):
        """Return (cells, bary): containing cell id (-1 if outside) and
        barycentric coordinates (nq, d+1)."""
        pts = np.asarray(pts, dtype=np.float64)
        nq, d = pts.shape
        cells = np.full(nq, -1, dtype=np.int64)
        bary = np.zeros((nq, d + 1))
        key = np.clip(((pts - self.gmin) / self.h).astype(np.int64), 0,
                      self.nb - 1)
        aug = np.concatenate([np.ones((nq, 1)), pts], axis=1)  # (nq, d+1)
        for q in range(nq):
            cand = self.bins.get(tuple(key[q]), ())
            for c in cand:
                lam = self.Tinv[c].T @ aug[q]
                if np.all(lam >= -eps):
                    cells[q] = c
                    bary[q] = lam
                    break
        return cells, bary


def vertex_tangents(curve: Mesh):
    """Averaged unit tangent per curve vertex (1D mesh in R^3)."""
    t = np.zeros((curve.num_vertices, curve.gdim))
    seg = curve.vertices[curve.cells[:, 1]] - curve.vertices[curve.cells[:, 0]]
    seg = seg / np.linalg.norm(seg, axis=1, keepdims=True)
    np.add.at(t, curve.cells[:, 0], seg)
    np.add.at(t, curve.cells[:, 1], seg)
    nrm = np.linalg.norm(t, axis=1, keepdims=True)
    return t / np.where(nrm > 0, nrm, 1.0)


def _orthonormal_frame(t):
    """Two unit vectors orthogonal to each tangent (n, 3) -> (n,3),(n,3)."""
    a = np.where(np.abs(t[:, 0:1]) < 0.9,
                 np.tile([1.0, 0, 0], (len(t), 1)),
                 np.tile([0, 1.0, 0], (len(t), 1)))
    u = np.cross(t, a)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(t, u)
    return u, v


def average_matrix(mesh3d: Mesh, curve: Mesh, radius=0.0, degree=10,
                   locator=None) -> HostCSR:
    """Pi: (n_curve, n_3d) averaging matrix.

    radius > 0: mean of the 3D field over the circle of that radius around
    each curve vertex (quadrature with `degree`+ points, trapezoid rule on
    the periodic circle — spectrally accurate, matching Circle(radius,
    degree=10) of emi_3d1d.py:65).
    radius = 0: pointwise trace at the curve vertex (emi_3d1d.py:68)."""
    if locator is None:
        locator = TetLocator(mesh3d)
    nV = curve.num_vertices
    pts_per = 1 if radius == 0.0 else max(4, int(degree) + 2)
    if radius == 0.0:
        pts = curve.vertices.copy()
        weights = np.ones((nV, 1))
    else:
        t = vertex_tangents(curve)
        u, v = _orthonormal_frame(t)
        ang = 2 * np.pi * np.arange(pts_per) / pts_per
        circ = (np.cos(ang)[None, :, None] * u[:, None, :]
                + np.sin(ang)[None, :, None] * v[:, None, :])  # (nV,nq,3)
        pts = curve.vertices[:, None, :] + radius * circ
        pts = pts.reshape(-1, 3)
        weights = np.full((nV, pts_per), 1.0 / pts_per)
    cells, bary = locator.locate(pts)
    # fall back to nearest vertex for points that fell outside the 3D mesh
    # (circle sticking out of the box): renormalize over located points
    cells2 = cells.reshape(nV, pts_per)
    located = cells2 >= 0
    wsum = (weights * located).sum(axis=1, keepdims=True)
    wsum = np.where(wsum > 0, wsum, 1.0)
    weights = np.where(located, weights, 0.0) / wsum

    d1 = mesh3d.tdim + 1
    rows = np.repeat(np.arange(nV), pts_per * d1)
    ok = np.repeat(cells >= 0, d1)
    cols = mesh3d.cells[np.maximum(cells, 0)].reshape(-1)
    vals = (weights.reshape(-1, 1) * bary[:, :d1]).reshape(-1)
    vals = np.where(ok, vals, 0.0)
    return HostCSR.from_coo(rows, cols.astype(np.int64), vals,
                            (nV, mesh3d.num_vertices))
