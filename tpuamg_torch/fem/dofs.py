"""DOF extraction helpers (copy of the JAX package's ``fem/dofs.py``).

Equivalents of the reference's ``get_interface_dofs`` (codim-1, via the
marker/DirichletBC trick) and ``get_coupling_dofs`` (same-dim, via the cell
dofmap) at reference utils.py:266-301 — defined there for the
upstream repo's use; provided here for API parity.
"""
from __future__ import annotations

import numpy as np

from .mesh import Mesh


def get_interface_dofs(mesh: Mesh, interface: Mesh) -> np.ndarray:
    """P1 dofs of `mesh` lying on a codim-1 interface mesh (the interface
    must have been extracted from `mesh`, carrying parent_vertex_map)."""
    assert interface.tdim == mesh.tdim - 1
    assert interface.parent is mesh or interface.parent_vertex_map is not None
    return np.unique(np.asarray(interface.parent_vertex_map,
                                dtype=np.int64))


def get_coupling_dofs(mesh: Mesh, submesh: Mesh) -> np.ndarray:
    """P1 dofs of `mesh` touched by the cells of a same-dimension submesh
    (utils.py:286-301 semantics: union of cell dofs)."""
    assert submesh.tdim == mesh.tdim
    assert submesh.parent_vertex_map is not None
    return np.unique(np.asarray(submesh.parent_vertex_map, dtype=np.int64))
