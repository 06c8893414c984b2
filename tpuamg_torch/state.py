"""Carry state across from the JAX package.

The functions here take the JAX package's operator objects (a ``DIA`` or
``PDIA``, a ``FusedVCycle``) and build the port's objects from their
numpy arrays and their specs' plain fields: offsets, level dims, K, rows,
theta, Chebyshev coefficients, degree, pre/post, nc, rows_c.  They never
import JAX: they read attributes and call ``numpy.asarray``.  Tests use
them to hold both packages to the same planes and the same coarse inverse
T, whatever each side's float32 LU would compute.
"""
from __future__ import annotations

import numpy as np
import torch

from .amg.grid_fused import CycleSpec, FusedVCycle, LevelSpec
from .kernels import LANES, resolve_device
from .sparse.dia_kernels import KernelDIA


def to_tensor(a, device=None):
    """numpy array (bfloat16 ones included, bit for bit) -> torch tensor."""
    a = np.ascontiguousarray(np.asarray(a))
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(dev)


def kernel_dia_from_jax(D, device=None) -> KernelDIA:
    """A JAX DIA (data (nd, n)) or PDIA (data2d (nd, rows, 128), zero
    padded) -> KernelDIA over the same n."""
    n = D.shape[0]
    if hasattr(D, "data2d"):
        d2 = np.asarray(D.data2d)
        planes = d2.reshape(d2.shape[0], -1)[:, :n]
    else:
        planes = np.asarray(D.data)
    return KernelDIA(D.offsets, to_tensor(planes, device), D.shape, D.nnz)


def _level_planes(blocked, n):
    """(nblocks, nd, rb, 128) plane blocks -> (nd, n), pad rows dropped."""
    b = np.asarray(blocked)
    nd = b.shape[1]
    return np.ascontiguousarray(
        b.transpose(1, 0, 2, 3).reshape(nd, -1)[:, :n])


def vcycle_from_jax(vc, F, device=None) -> FusedVCycle:
    """A JAX FusedVCycle -> the port's FusedVCycle on the same hierarchy:
    the same planes, mask, T and Chebyshev parameters; the JAX rows_p
    padding and halos dropped (both are zeros)."""
    jspec = vc.spec
    levels, A_p, C_p, M_p = [], [], [], []
    for lv, S in enumerate(jspec.levels):
        n = S.rows * LANES
        levels.append(LevelSpec(
            lead=tuple(S.lead), K=int(S.K), rows=int(S.rows),
            offsA=tuple(S.offsA), offsC=tuple(S.offsC),
            theta=float(S.theta), coefs=tuple(S.coefs),
            degree=int(S.degree), pre=int(S.pre), post=int(S.post)))
        A_p.append(to_tensor(_level_planes(vc.A_planes[lv], n), device))
        C_p.append(to_tensor(_level_planes(vc.C_planes[lv], n), device))
        M_p.append(to_tensor(np.asarray(vc.M_planes[lv]).reshape(-1)[:n],
                             device))
    spec = CycleSpec(levels=tuple(levels), F=int(F), Kc=int(jspec.Kc),
                     rows_c=int(jspec.rows_c), nc=int(jspec.nc),
                     cycle=getattr(jspec, "cycle", "v"),
                     max_w_work=int(getattr(jspec, "max_w_work", 64)))
    n0 = levels[0].n
    mask = to_tensor(np.asarray(vc.mask_flat, dtype=np.float32)[:n0],
                     device)
    return FusedVCycle(spec, A_p, C_p, M_p, to_tensor(vc.T, device), mask,
                       level_nnz=vc.level_nnz, coarse_n=vc.coarse_n)
