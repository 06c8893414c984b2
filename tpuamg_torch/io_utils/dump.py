"""System dump/load: the assemble -> solve -> visualize checkpoint pipeline.

Copy of the JAX package's ``io_utils/dump.py``: a dump written by either
package loads in the other.  Format-compatible with the reference's handoff files (SURVEY.md §5.4):
- ``A.npy``: COO triplets ``np.c_[row, col, data]``
  (reference utils.py:304-333),
- ``b.npy``: dense RHS vector,
- ``idofs.npy`` / ``idofs3d.npy``: interface / 3d dof index ranges,
- ``solution.txt``: length-prefixed flat solution vector
  (reference emi_3d1d.py:150-152).
"""
from __future__ import annotations

import os

import numpy as np

from ..sparse import HostCSR


def dump_system(A: HostCSR, b, sizes, folder, coords=None, coupling=None,
                gamma=None):
    """Write A (COO), b, idofs, idofs3d — utils.py:304-333 layout.

    coords: optional (n, d) dof coordinates, saved as ``coords.npy`` —
    an ADDITION to the reference format that lets the offline solver use
    the structured (gather-free) path; absent -> the loader falls back to
    the algebraic path.

    coupling: optional (Pi, Mq) metric factorization (A = AD + gamma *
    R^T Mq R, R = [-Pi, I]) saved as ``Pi.npy``/``Mq.npy`` COO triplets
    plus ``gamma.npy`` — a further extension letting the offline solver
    build gamma-exact smoothers without re-deriving the split from A."""
    os.makedirs(folder, exist_ok=True)
    r, c, v = A.to_coo()
    if not (np.all(np.isfinite(v)) and np.all(np.isfinite(b))):
        raise ValueError("dump_system: A or b has a non-finite entry")
    np.save(os.path.join(folder, "A.npy"),
            np.c_[r.astype(np.float64), c.astype(np.float64), v])
    np.save(os.path.join(folder, "b.npy"), np.asarray(b, dtype=np.float64))
    n1 = sizes[0]
    ntot = sum(sizes)
    np.save(os.path.join(folder, "idofs.npy"),
            np.arange(n1, ntot, dtype=np.int32))
    np.save(os.path.join(folder, "idofs3d.npy"),
            np.arange(n1, dtype=np.int32))
    if coords is not None:
        np.save(os.path.join(folder, "coords.npy"),
                np.asarray(coords, dtype=np.float64))
    if coupling is not None:
        Pi, Mq = coupling
        for name, M in (("Pi", Pi), ("Mq", Mq)):
            rr, cc, vv = M.to_coo()
            np.save(os.path.join(folder, f"{name}.npy"),
                    np.c_[rr.astype(np.float64), cc.astype(np.float64),
                          vv])
        np.save(os.path.join(folder, "gamma.npy"),
                np.asarray([0.0 if gamma is None else float(gamma),
                            float(Pi.shape[0]), float(Pi.shape[1])]))


def load_system(folder, with_coords=False):
    """Read the dump back: (A: HostCSR, b, idofs, idofs3d[, coords])."""
    coo = np.load(os.path.join(folder, "A.npy"))
    b = np.load(os.path.join(folder, "b.npy"))
    idofs = np.load(os.path.join(folder, "idofs.npy"))
    idofs3d = np.load(os.path.join(folder, "idofs3d.npy"))
    n = len(b)
    A = HostCSR.from_coo(coo[:, 0].astype(np.int64),
                         coo[:, 1].astype(np.int64), coo[:, 2], (n, n))
    if with_coords:
        cpath = os.path.join(folder, "coords.npy")
        coords = np.load(cpath) if os.path.exists(cpath) else None
        return A, b, idofs, idofs3d, coords
    return A, b, idofs, idofs3d


def load_coupling(folder):
    """Read the optional metric factorization dump:
    (gamma, Pi: HostCSR, Mq: HostCSR) or None when absent."""
    gpath = os.path.join(folder, "gamma.npy")
    if not os.path.exists(gpath):
        return None
    gamma, n1, n3 = np.load(gpath)
    out = []
    for name, shape in (("Pi", (int(n1), int(n3))),
                        ("Mq", (int(n1), int(n1)))):
        coo = np.load(os.path.join(folder, f"{name}.npy"))
        out.append(HostCSR.from_coo(coo[:, 0].astype(np.int64),
                                    coo[:, 1].astype(np.int64),
                                    coo[:, 2], shape))
    return float(gamma), out[0], out[1]


def write_solution(path_or_dir, x):
    """solution.txt: first entry is the length (emi_3d1d.py:150-152)."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, "solution.txt")
    out = np.concatenate([[float(len(x))], np.asarray(x, dtype=np.float64)])
    np.savetxt(path, out)
    return path


def read_solution(path_or_dir):
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, "solution.txt")
    sol = np.loadtxt(path)
    size = int(sol[0])
    return sol[1:1 + size]
