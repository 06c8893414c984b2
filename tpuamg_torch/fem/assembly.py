"""P1 Lagrange finite element assembly (vectorized numpy, host side).

Rebuilds the used DOLFIN/xii assembly surface (SURVEY.md §2b): stiffness and
mass matrices, load vectors with quadrature, boundary (facet) integrals for
Neumann data, and symmetric Dirichlet elimination matching ``xii.apply_bc``
(reference bidomain_2d.py:96-97).

P1 on simplices: dofs are vertices.  Element matrices come from exact
formulas (affine map), load/boundary terms from the quadrature module.
"""
from __future__ import annotations

import numpy as np

from ..sparse import HostCSR
from .mesh import Mesh
from .quadrature import simplex_rule


def _p1_gradients(mesh: Mesh):
    """Per-cell constant gradients of the d+1 barycentric basis functions.

    Returns (grads, vols): grads (nc, d+1, gdim), vols (nc,).
    Valid for tdim == gdim (full-dimensional cells)."""
    X = mesh.cell_coords()                        # (nc, d+1, g)
    d = mesh.tdim
    nc = mesh.num_cells
    ones = np.ones((nc, d + 1, 1))
    A = np.concatenate([ones, X], axis=2)         # (nc, d+1, d+1)
    Ainv = np.linalg.inv(A)
    grads = Ainv[:, 1:, :].transpose(0, 2, 1)     # (nc, d+1, d)
    vols = np.abs(np.linalg.det(A)) / np.prod(np.arange(1, d + 1))
    return grads, vols


def stiffness_matrix(mesh: Mesh, kappa=1.0) -> HostCSR:
    """∫ kappa ∇u·∇v dx.  kappa: scalar or per-cell array.

    Works on manifold meshes (tdim < gdim, e.g. the 1D neuron curve in R^3,
    emi_3d1d.py:80) using tangential gradients via the Gram inverse."""
    kap = np.broadcast_to(np.asarray(kappa, dtype=np.float64),
                          (mesh.num_cells,))
    if mesh.tdim == mesh.gdim:
        grads, vols = _p1_gradients(mesh)
        Ke = np.matmul(grads, grads.transpose(0, 2, 1)) \
            * (kap * vols)[:, None, None]
        return _scatter_cell_matrices(mesh, Ke)
    # manifold: grad lam_i . grad lam_j = (G^{-1})_{ij} for i,j >= 1,
    # lam_0 = 1 - sum(lam_i)
    X = mesh.cell_coords()
    D = X[:, 1:] - X[:, :1]                       # (nc, tdim, g)
    G = np.einsum("cik,cjk->cij", D, D)
    Ginv = np.linalg.inv(G)
    vols = mesh.cell_volumes()
    d = mesh.tdim
    B = np.zeros((mesh.num_cells, d + 1, d + 1))
    B[:, 1:, 1:] = Ginv
    B[:, 0, 1:] = -Ginv.sum(axis=1)
    B[:, 1:, 0] = -Ginv.sum(axis=2)
    B[:, 0, 0] = Ginv.sum(axis=(1, 2))
    Ke = B * (kap * vols)[:, None, None]
    return _scatter_cell_matrices(mesh, Ke)


def mass_matrix(mesh: Mesh, coeff=1.0) -> HostCSR:
    """∫ coeff u v dx (consistent P1 mass). Works on manifold meshes
    (interface curves/surfaces) via Gram-determinant volumes."""
    d = mesh.tdim
    vols = mesh.cell_volumes()
    co = np.broadcast_to(np.asarray(coeff, dtype=np.float64),
                         (mesh.num_cells,))
    base = (np.ones((d + 1, d + 1)) + np.eye(d + 1)) / ((d + 1) * (d + 2))
    Me = base[None] * (co * vols)[:, None, None]
    return _scatter_cell_matrices(mesh, Me)


def _scatter_cell_matrices(mesh: Mesh, Ae) -> HostCSR:
    d1 = mesh.tdim + 1
    cells = mesh.cells.astype(np.int64)
    rows = np.repeat(cells, d1, axis=1).ravel()
    cols = np.tile(cells, (1, d1)).ravel()
    n = mesh.num_vertices
    return HostCSR.from_coo(rows, cols, Ae.ravel(), (n, n))


def load_vector(mesh: Mesh, f, degree=4):
    """∫ f v dx with a degree-`degree` rule.  f: (n, gdim) -> (n,)."""
    bary, w = simplex_rule(mesh.tdim, degree)
    X = mesh.cell_coords()                        # (nc, d+1, g)
    # pts[c,q,g] = sum_a bary[q,a] X[c,a,g]  (3-operand einsum was a
    # profile hot spot; batched matmul hits BLAS)
    pts = np.matmul(bary, X)                      # (nc, nq, g)
    fv = np.asarray(f(pts.reshape(-1, mesh.gdim))).reshape(pts.shape[:2])
    vols = mesh.cell_volumes()
    # b_local[c, a] = vol_c * sum_q w_q f(x_q) phi_a(x_q);  phi_a = bary[:, a]
    be = vols[:, None] * ((fv * w) @ bary)
    return np.bincount(mesh.cells.astype(np.int64).ravel(),
                       weights=be.ravel(), minlength=mesh.num_vertices)


def facet_load_vector(mesh: Mesh, g, tags, degree=4):
    """∫ g v ds over boundary facets with the given tags.

    g: (n, gdim) -> (n,). Implements the Neumann terms of
    reference bidomain_2d.py:90-91."""
    assert mesh.facets is not None
    tags = np.atleast_1d(tags)
    sel = np.isin(mesh.facet_markers, tags)
    facets = mesh.facets[sel]
    b = np.zeros(mesh.num_vertices)
    if len(facets) == 0:
        return b
    fdim = mesh.tdim - 1
    bary, w = simplex_rule(fdim, degree)
    X = mesh.vertices[facets]                     # (nf, fdim+1, g)
    pts = np.matmul(bary, X)                      # (nf, nq, g)
    gv = np.asarray(g(pts.reshape(-1, mesh.gdim))).reshape(pts.shape[:2])
    # facet measures via Gram determinant
    D = X[:, 1:] - X[:, :1]
    G = np.einsum("fik,fjk->fij", D, D)
    if fdim == 1:
        vols = np.sqrt(np.maximum(G[:, 0, 0], 0))
    else:
        vols = np.sqrt(np.maximum(np.linalg.det(G), 0)) / np.prod(
            np.arange(1, fdim + 1))
    be = vols[:, None] * ((gv * w) @ bary)
    b += np.bincount(facets.astype(np.int64).ravel(), weights=be.ravel(),
                     minlength=mesh.num_vertices)
    return b


def facet_normals(mesh: Mesh, facets):
    """Outward unit normals for boundary facets (owner-cell based)."""
    # For our axis-aligned tagged boundaries normals are trivial, but keep a
    # general implementation: normal orthogonal to facet span, pointing away
    # from the owner cell centroid.
    X = mesh.vertices[facets]                     # (nf, fdim+1, g)
    g = mesh.gdim
    if mesh.tdim == 2:
        t = X[:, 1] - X[:, 0]
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
    elif mesh.tdim == 3:
        n = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
    else:
        raise ValueError(mesh.tdim)
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    return n


class DirichletBC:
    """Dirichlet data on tagged boundary facets of a P1 space.

    Mirrors DOLFIN DirichletBC + get_boundary_values
    (reference emi_2d.py:205)."""

    def __init__(self, mesh: Mesh, value, tags):
        self.mesh = mesh
        self.dofs = mesh.boundary_vertices(tags)
        if callable(value):
            self.values = np.asarray(value(mesh.vertices[self.dofs]))
        else:
            self.values = np.full(len(self.dofs), float(value))

    def get_boundary_values(self):
        return dict(zip(self.dofs.tolist(), self.values.tolist()))


def apply_bc_monolithic(A: HostCSR, b, bcs_dofs, bcs_values):
    """Symmetric Dirichlet elimination on an assembled monolithic system.

    A <- A with bc rows/cols zeroed and unit diagonal;
    b <- b - A[:, bc] g, then b[bc] = g.   (xii.apply_bc semantics.)
    """
    dofs = np.asarray(bcs_dofs, dtype=np.int64)
    vals = np.asarray(bcs_values, dtype=np.float64)
    g = np.zeros(A.shape[1])
    g[dofs] = vals
    newA, colA = A.eliminate_rows_cols(dofs)
    b = np.asarray(b, dtype=np.float64).copy()
    b -= colA.matvec(g)
    b[dofs] = vals
    return newA, b


def interpolate(mesh: Mesh, f):
    """P1 interpolant: evaluate at vertices."""
    return np.asarray(f(mesh.vertices))
