"""Structured simplicial meshes with boundary/cell markers.

Rebuilds the used surface of DOLFIN's mesh layer (SURVEY.md §2b):
``UnitSquareMesh``/``UnitCubeMesh`` generation, ``MeshFunction`` markers via
ordered predicate marking (semantics of ``CompiledSubDomain(...).mark``,
reference utils.py:149-260), submesh extraction with parent maps
(``xii.EmbeddedMesh``), and interface meshes with two-sided embeddings
(``compute_embedding``, reference utils.py:219-220).

All host-side numpy; device code only ever sees assembled operators.
"""
from __future__ import annotations

import numpy as np

EPS = 1e-12


class Mesh:
    """Simplicial mesh: tdim-simplices embedded in R^gdim."""

    def __init__(self, vertices, cells):
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float64)
        self.cells = np.ascontiguousarray(cells, dtype=np.int32)
        self.gdim = self.vertices.shape[1]
        self.tdim = self.cells.shape[1] - 1
        # markers
        self.cell_markers = np.zeros(len(self.cells), dtype=np.int32)
        self.facets = None          # (nf, tdim) vertex ids (boundary only)
        self.facet_markers = None   # (nf,) tags
        # submesh bookkeeping
        self.parent_vertex_map = None  # vertex id in parent mesh
        self.parent = None

    # -- basic metrics -------------------------------------------------
    @property
    def num_vertices(self):
        return len(self.vertices)

    @property
    def num_cells(self):
        return len(self.cells)

    def cell_coords(self):
        """(nc, tdim+1, gdim) coordinates of cell vertices."""
        return self.vertices[self.cells]

    def hmin(self):
        """Min cell diameter (longest edge), as DOLFIN mesh.hmin()."""
        X = self.cell_coords()
        d = self.tdim + 1
        h = 0.0
        hmax = np.zeros(len(X))
        for i in range(d):
            for j in range(i + 1, d):
                e = np.linalg.norm(X[:, i] - X[:, j], axis=1)
                hmax = np.maximum(hmax, e)
        return float(hmax.min())

    def cell_volumes(self):
        """Simplex measures; works for manifolds (tdim < gdim) via Gram det."""
        X = self.cell_coords()
        D = X[:, 1:] - X[:, :1]                      # (nc, tdim, gdim)
        G = np.einsum("cik,cjk->cij", D, D)           # Gram
        det = np.linalg.det(G)
        fact = np.prod(np.arange(1, self.tdim + 1))
        return np.sqrt(np.maximum(det, 0.0)) / fact

    # -- boundary ------------------------------------------------------
    def _cell_facets(self):
        """All facets of all cells: (nc*(tdim+1), tdim) with parent cell."""
        d = self.tdim
        nc = self.num_cells
        idx = []
        for omit in range(d + 1):
            keep = [k for k in range(d + 1) if k != omit]
            idx.append(self.cells[:, keep])
        facets = np.concatenate(idx, axis=0)          # (nc*(d+1), d)
        owner = np.tile(np.arange(nc), d + 1)
        return facets, owner

    def init_boundary(self):
        """Extract boundary facets (those shared by exactly one cell)."""
        facets, owner = self._cell_facets()
        key = np.sort(facets, axis=1)
        order = np.lexsort(key.T[::-1])
        key_s = key[order]
        same = np.all(key_s[1:] == key_s[:-1], axis=1)
        # boundary = rows not equal to either neighbor
        nb = len(key_s)
        is_dup = np.zeros(nb, dtype=bool)
        is_dup[1:] |= same
        is_dup[:-1] |= same
        bnd = order[~is_dup]
        self.facets = facets[bnd]
        self.facet_owner = owner[bnd]
        self.facet_markers = np.zeros(len(bnd), dtype=np.int32)
        return self

    def mark_facets(self, predicate, tag):
        """Mark boundary facets where *all* vertices satisfy predicate(x).

        predicate: (n, gdim) -> (n,) bool.  Marks override previous tags,
        mirroring DOLFIN's ordered CompiledSubDomain.mark calls."""
        assert self.facets is not None, "call init_boundary() first"
        ok = predicate(self.vertices)          # per-vertex
        hit = np.all(ok[self.facets], axis=1)
        self.facet_markers[hit] = tag
        return self

    def mark_cells(self, predicate, tag):
        """Mark cells where all vertices satisfy predicate."""
        ok = predicate(self.vertices)
        hit = np.all(ok[self.cells], axis=1)
        self.cell_markers[hit] = tag
        return self

    def facets_with_tag(self, tag):
        return self.facets[self.facet_markers == tag]

    def boundary_vertices(self, tags):
        """Unique vertex ids on facets with any of the given tags."""
        tags = np.atleast_1d(tags)
        m = np.isin(self.facet_markers, tags)
        if not m.any():
            return np.empty(0, dtype=np.int64)
        return np.unique(self.facets[m])


# ---------------------------------------------------------------------------
# Generators (reference: utils.py:149-182)
# ---------------------------------------------------------------------------

def unit_square_mesh(nx, ny=None):
    """n x n unit square, each square split into 2 triangles (DOLFIN
    'right' diagonal). Matches reference utils.py:154."""
    ny = nx if ny is None else ny
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)
    vid = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    v00 = vid[:-1, :-1].ravel()
    v10 = vid[1:, :-1].ravel()
    v01 = vid[:-1, 1:].ravel()
    v11 = vid[1:, 1:].ravel()
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    cells = np.concatenate([t1, t2], axis=0)
    return Mesh(vertices, cells)


_KUHN_TETS = np.array([  # 6-tet Kuhn subdivision of the unit cube
    [0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
    [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]], dtype=np.int64)


def unit_cube_mesh(nx, ny=None, nz=None):
    """n^3 unit cube, each cube split into 6 tets (Kuhn)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    xs = np.linspace(0, 1, nx + 1)
    ys = np.linspace(0, 1, ny + 1)
    zs = np.linspace(0, 1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    vid = np.arange((nx + 1) * (ny + 1) * (nz + 1)).reshape(
        nx + 1, ny + 1, nz + 1)
    # 8 cube corners, bit k of index = offset along axis k (x=bit2,y=bit1,z=bit0)
    corners = []
    for b in range(8):
        dx, dy, dz = (b >> 2) & 1, (b >> 1) & 1, b & 1
        corners.append(vid[dx:nx + dx + 0 or None, :, :]
                       [:, dy:ny + dy + 0 or None, :]
                       [:, :, dz:nz + dz + 0 or None].ravel())
    corners = np.stack(corners, axis=1)               # (ncubes, 8)
    cells = corners[:, _KUHN_TETS].reshape(-1, 4)
    return Mesh(vertices, cells)


def near(coord_idx, value):
    """Predicate factory: x[coord_idx] ≈ value (DOLFIN `near`)."""
    def pred(x):
        return np.abs(x[:, coord_idx] - value) < 1e-10
    return pred


def pred_and(*ps):
    def pred(x):
        out = ps[0](x)
        for p in ps[1:]:
            out = out & p(x)
        return out
    return pred


def pred_or(*ps):
    def pred(x):
        out = ps[0](x)
        for p in ps[1:]:
            out = out | p(x)
        return out
    return pred


def le(coord_idx, value):
    def pred(x):
        return x[:, coord_idx] < value + EPS
    return pred


def ge(coord_idx, value):
    def pred(x):
        return x[:, coord_idx] > value - EPS
    return pred


def tagged_unit_square(n):
    """Unit square with the bidomain boundary tags
    (1: x=0, 2: x=1, 3: y=0, 4: y=1) — reference utils.py:158-162."""
    mesh = unit_square_mesh(n)
    mesh.init_boundary()
    mesh.mark_facets(near(0, 0.0), 1)
    mesh.mark_facets(near(0, 1.0), 2)
    mesh.mark_facets(near(1, 0.0), 3)
    mesh.mark_facets(near(1, 1.0), 4)
    return mesh


def tagged_unit_cube(n):
    """Unit cube with bidomain_3d tags (1: z=0, 2: z=1, 3: y=0|1, 4: x=0|1)
    — reference utils.py:176-180."""
    mesh = unit_cube_mesh(n)
    mesh.init_boundary()
    mesh.mark_facets(near(2, 0.0), 1)
    mesh.mark_facets(near(2, 1.0), 2)
    mesh.mark_facets(pred_or(near(1, 0.0), near(1, 1.0)), 3)
    mesh.mark_facets(pred_or(near(0, 0.0), near(0, 1.0)), 4)
    return mesh


# ---------------------------------------------------------------------------
# Submeshes / embedded meshes (reference: xii.EmbeddedMesh)
# ---------------------------------------------------------------------------

def submesh_from_cells(mesh: Mesh, cell_ids) -> Mesh:
    """Extract the submesh of the given cells; keeps parent vertex map."""
    cell_ids = np.asarray(cell_ids)
    cells = mesh.cells[cell_ids]
    used = np.unique(cells)
    new_id = np.full(mesh.num_vertices, -1, dtype=np.int64)
    new_id[used] = np.arange(len(used))
    sub = Mesh(mesh.vertices[used], new_id[cells])
    sub.parent_vertex_map = used
    sub.parent = mesh
    return sub


def submesh_where_marker(mesh: Mesh, tag) -> Mesh:
    return submesh_from_cells(mesh, np.flatnonzero(mesh.cell_markers == tag))


def mesh_from_facets(facets, parent: Mesh) -> Mesh:
    """Build a codim-1 mesh from parent facets (xii.EmbeddedMesh on a facet
    marker)."""
    used = np.unique(facets)
    new_id = np.full(parent.num_vertices, -1, dtype=np.int64)
    new_id[used] = np.arange(len(used))
    m = Mesh(parent.vertices[used], new_id[facets])
    m.parent_vertex_map = used
    m.parent = parent
    return m


def embed_vertices(child: Mesh, other: Mesh, tol=1e-10):
    """Map child's vertices into `other`'s vertex numbering by coordinate
    matching (xii compute_embedding, reference utils.py:220).
    Returns int array: other-vertex id per child vertex."""
    # hash coordinates via lexsort-based matching
    oc = other.vertices
    cc = child.vertices
    # round to tolerance grid
    key_o = np.round(oc / tol).astype(np.int64)
    key_c = np.round(cc / tol).astype(np.int64)
    # dictionary via structured sort
    order = np.lexsort(key_o.T[::-1])
    ko = key_o[order]
    out = np.empty(len(cc), dtype=np.int64)
    for i, k in enumerate(key_c):   # child meshes are small (interfaces)
        lo, hi = 0, len(ko)
        j = np.searchsorted(
            ko[:, 0], k[0], side="left")
        # linear scan among equal first keys (few)
        found = -1
        while j < len(ko) and ko[j, 0] == k[0]:
            if np.all(ko[j] == k):
                found = order[j]
                break
            j += 1
        if found < 0:
            raise ValueError(f"vertex {cc[i]} not found in other mesh")
        out[i] = found
    return out
