"""Bidomain model problems (2D/3D): assembly of the monolithic system and
the H1 errors of a solution.

Copy of the JAX package's ``problems/bidomain.py`` (P1 only), which
rebuilds the reference drivers bidomain_2d.py and bidomain_3d.py:

    -div(kappa1 grad u1) + gamma (u1 - u2) = f1
    -div(kappa2 grad u2) + gamma (u2 - u1) = f2

on the unit square/cube; Dirichlet on tags (1,2), Neumann (full stress) on
the rest (bidomain_2d.py:73-91).  The 2x2 block operator is
    [K1 + gamma M   , -gamma M      ]
    [-gamma M       , K2 + gamma M  ]
i.e. A = A_elliptic + gamma * M_metric — the metric-perturbed form the AMG
is built for (SURVEY.md §0).
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from ..fem import (tagged_unit_square, tagged_unit_cube, stiffness_matrix,
                   mass_matrix, load_vector, apply_bc_monolithic,
                   errornorm_p1)
from ..sparse import bmat

Params = namedtuple("Params", ("kappa1", "kappa2", "gamma"))

# outward unit normals of the tagged boundaries (utils.py:158-162, 176-180)
SQUARE_NORMALS = {1: np.array([-1.0, 0.0]), 2: np.array([1.0, 0.0]),
                  3: np.array([0.0, -1.0]), 4: np.array([0.0, 1.0])}
CUBE_NORMALS = {1: np.array([0.0, 0.0, -1.0]), 2: np.array([0.0, 0.0, 1.0])}
# cube tags 3,4 cover two opposite faces each; handled facet-wise below.

DIRICHLET_TAGS = (1, 2)
NEUMANN_TAGS = (3, 4)


def get_mesh(ncells, dim):
    return tagged_unit_square(ncells) if dim == 2 else \
        tagged_unit_cube(ncells)


def _neumann_rhs(mesh, flux, tags):
    """sum over tags of  -∫ (sigma.n) v ds  (bidomain_2d.py:90-91).

    Handles tags whose facets span opposite faces (cube tags 3,4) by
    splitting per-face using the facet vertex coordinates."""
    out = np.zeros(mesh.num_vertices)
    dim = mesh.gdim
    for tag in tags:
        # For the cube, tag 3 = {y=0, y=1}, tag 4 = {x=0, x=1}
        facets = mesh.facets_with_tag(tag)
        if len(facets) == 0:
            continue
        centers = mesh.vertices[facets].mean(axis=1)
        if dim == 2:
            n_of = {0: SQUARE_NORMALS[tag]}
            key = np.zeros(len(facets), dtype=np.int64)
        else:
            if tag in (1, 2):
                n_of = {0: CUBE_NORMALS[tag]}
                key = np.zeros(len(facets), dtype=np.int64)
            elif tag == 3:
                n_of = {0: np.array([0.0, -1.0, 0.0]),
                        1: np.array([0.0, 1.0, 0.0])}
                key = (centers[:, 1] > 0.5).astype(np.int64)
            else:
                n_of = {0: np.array([-1.0, 0.0, 0.0]),
                        1: np.array([1.0, 0.0, 0.0])}
                key = (centers[:, 0] > 0.5).astype(np.int64)
        for k, nvec in n_of.items():
            sel = facets[key == k]
            if len(sel) == 0:
                continue
            out += _facet_integral(mesh, sel,
                                   lambda x: -(flux(x) @ nvec))
    return out


def _facet_integral(mesh, facets, g, degree=4):
    """∫ g v ds over an explicit facet list."""
    from ..fem.quadrature import simplex_rule
    b = np.zeros(mesh.num_vertices)
    fdim = mesh.tdim - 1
    bary, w = simplex_rule(fdim, degree)
    X = mesh.vertices[facets]
    pts = np.einsum("qa,fag->fqg", bary, X)
    gv = np.asarray(g(pts.reshape(-1, mesh.gdim))).reshape(pts.shape[:2])
    D = X[:, 1:] - X[:, :1]
    G = np.einsum("fik,fjk->fij", D, D)
    if fdim == 1:
        vols = np.sqrt(np.maximum(G[:, 0, 0], 0))
    else:
        vols = np.sqrt(np.maximum(np.linalg.det(G), 0)) / np.prod(
            np.arange(1, fdim + 1))
    be = vols[:, None] * np.einsum("fq,q,qa->fa", gv, w, bary)
    np.add.at(b, facets.astype(np.int64).ravel(), be.ravel())
    return b


def get_system(mesh, data, params: Params, pdegree=1):
    """Assemble the monolithic bidomain system with symmetric Dirichlet
    elimination.  Returns (A_mono, b_mono, (n1, n2), bc_dofs).
    pdegree: 1 (vertex dofs); P2 is not ported yet."""
    k1, k2, g = params.kappa1, params.kappa2, params.gamma

    assert pdegree == 1, f"unsupported pdegree {pdegree} (P2 not ported)"
    n = mesh.num_vertices
    K1 = stiffness_matrix(mesh, k1)
    K2 = stiffness_matrix(mesh, k2)
    M = mass_matrix(mesh)
    b0 = load_vector(mesh, data["f1"]) + _neumann_rhs(
        mesh, data["flux1"], NEUMANN_TAGS)
    b1 = load_vector(mesh, data["f2"]) + _neumann_rhs(
        mesh, data["flux2"], NEUMANN_TAGS)
    bd = mesh.boundary_vertices(DIRICHLET_TAGS)
    coords = mesh.vertices[bd]

    A00 = K1.add(M, beta=g)
    A01 = M.scale(-g)
    A11 = K2.add(M, beta=g)
    A = bmat([[A00, A01], [A01, A11]])
    b = np.concatenate([b0, b1])

    bc_dofs = np.concatenate([bd, n + bd])
    bc_vals = np.concatenate([data["u1"](coords), data["u2"](coords)])
    A, b = apply_bc_monolithic(A, b, bc_dofs, bc_vals)
    return A, b, (n, n), bc_dofs


def compute_errors(mesh, data, x, sizes, pdegree=1):
    """H1 errors (|u1 - u1h|_1, |u2 - u2h|_1) of a P1 solution x."""
    if pdegree != 1:
        raise NotImplementedError(
            "P2 error norms wait for fem/pk.py (ROADMAP Queue 1 item 11)")
    n1, _ = sizes
    u1h, u2h = x[:n1], x[n1:]
    e1 = errornorm_p1(data["u1"], data["grad_u1"], mesh, u1h, "H1")
    e2 = errornorm_p1(data["u2"], data["grad_u2"], mesh, u2h, "H1")
    return e1, e2
