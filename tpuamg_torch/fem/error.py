"""Error norms against exact solutions (quadrature-based).

Copy of the JAX package's ``fem/error.py``.  Equivalent of DOLFIN
``errornorm(u_exact, uh, 'H1', degree_rise=1)`` (reference
bidomain_2d.py:241): integrates |u - uh|^2 and
|grad u - grad uh|^2 directly with a high-order rule, which is the honest
form of what errornorm does via interpolation into a richer space.
"""
from __future__ import annotations

import numpy as np

from .mesh import Mesh
from .quadrature import simplex_rule
from .assembly import _p1_gradients


def errornorm_p1(u_exact, grad_exact, mesh: Mesh, uh, norm="H1", degree=5):
    """‖u_exact − uh‖ for a P1 field uh (nodal values on mesh vertices).

    u_exact: (n, gdim) -> (n,);  grad_exact: (n, gdim) -> (n, gdim).
    norm: 'L2', 'H1' (full), or 'H10' (seminorm).
    """
    bary, w = simplex_rule(mesh.tdim, degree)
    X = mesh.cell_coords()
    pts = np.einsum("qa,cag->cqg", bary, X)       # (nc, nq, g)
    flat = pts.reshape(-1, mesh.gdim)
    uh_nodes = np.asarray(uh)[mesh.cells]          # (nc, d+1)

    vols = mesh.cell_volumes()
    err2 = 0.0
    if norm in ("L2", "H1"):
        ue = np.asarray(u_exact(flat)).reshape(pts.shape[:2])
        uhq = np.einsum("qa,ca->cq", bary, uh_nodes)
        err2 += np.einsum("cq,q,c->", (ue - uhq) ** 2, w, vols)
    if norm in ("H1", "H10"):
        ge = np.asarray(grad_exact(flat)).reshape(
            pts.shape[0], pts.shape[1], mesh.gdim)
        grads, _ = _p1_gradients(mesh)
        gh = np.einsum("cad,ca->cd", grads, uh_nodes)   # constant per cell
        diff2 = np.sum((ge - gh[:, None, :]) ** 2, axis=2)
        err2 += np.einsum("cq,q,c->", diff2, w, vols)
    return float(np.sqrt(err2))
