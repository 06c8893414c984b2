"""Minimal VTU (VTK XML unstructured grid) writer for P1 fields.

Copy of the JAX package's ``io_utils/vtk.py``.

Visualization-output role of the reference's PVD files
(reference bidomain_2d.py:276-278, emi_3d1d.py:159-160).
Supports line (1D), triangle (2D) and tet (3D) meshes; ASCII format
readable by ParaView.
"""
from __future__ import annotations

import numpy as np

_VTK_CELL = {1: 3, 2: 5, 3: 10}   # line, triangle, tetra


def write_vtu(path, mesh, point_data, name="u"):
    verts = np.asarray(mesh.vertices, dtype=np.float64)
    if verts.shape[1] < 3:
        verts = np.pad(verts, ((0, 0), (0, 3 - verts.shape[1])))
    cells = np.asarray(mesh.cells, dtype=np.int64)
    npts, ncls = len(verts), len(cells)
    ctype = _VTK_CELL[mesh.tdim]
    u = np.asarray(point_data, dtype=np.float64)

    def arr(a, fmt="%g"):
        return " ".join(fmt % v for v in np.asarray(a).ravel())

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n'
                '<VTKFile type="UnstructuredGrid" version="0.1">\n'
                '<UnstructuredGrid>\n'
                f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncls}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        f.write(arr(verts))
        f.write('\n</DataArray></Points>\n<Cells>\n')
        f.write('<DataArray type="Int64" Name="connectivity" '
                'format="ascii">\n' + arr(cells, "%d"))
        f.write('\n</DataArray>\n<DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        f.write(arr((np.arange(ncls) + 1) * cells.shape[1], "%d"))
        f.write('\n</DataArray>\n<DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        f.write(arr(np.full(ncls, ctype), "%d"))
        f.write('\n</DataArray>\n</Cells>\n')
        f.write(f'<PointData Scalars="{name}">\n'
                f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
        f.write(arr(u))
        f.write('\n</DataArray>\n</PointData>\n'
                '</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')
    return path


def write_pvd(path, vtu_paths):
    """PVD collection file referencing VTU pieces."""
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n'
                '<VTKFile type="Collection" version="0.1">\n'
                '<Collection>\n')
        for i, p in enumerate(vtu_paths):
            f.write(f'<DataSet timestep="{i}" part="0" file="{p}"/>\n')
        f.write('</Collection>\n</VTKFile>\n')
    return path
