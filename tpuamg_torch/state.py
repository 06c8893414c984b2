"""Carry state across from the JAX package.

The functions here take the JAX package's operator objects (a ``DIA`` or
``PDIA``, a ``FusedVCycle``, a ``FusedPCG``, the ``MGPreconditioner`` of
``setup_grid`` or of the algebraic ``setup_amg``) and build the port's
objects from their numpy arrays and their plain fields: offsets, level
dims, K, rows, theta, Chebyshev coefficients and intervals, degree,
pre/post, nc, rows_c, ELL planes, aggregate maps, color and Schwarz block
data, cycle settings, and the structured hierarchy's window levels
(DIA planes or StructuredOp blocks and spill, masks, block inverses,
Chebyshev intervals, footprint Schwarz data) and host tails.
They never import JAX: they read attributes and call ``numpy.asarray``.
Tests use them to hold both packages to the same planes and the same
coarse inverse, whatever each side's float32 LU would compute.
"""
from __future__ import annotations

import numpy as np
import torch

from .amg.grid import ChebyshevDiagSmoother, GridLevel
from .amg.grid_fused import CycleSpec, FusedPCG, FusedVCycle, LevelSpec
from .amg.hierarchy import MGLevel, MGPreconditioner
from .amg.structured import (BlockChebyshevSmoother, DiaChebyshevSmoother,
                             FootprintMetricSmoother, HostTailHybrid,
                             StructuredLevel, StructuredOp)
from .kernels import LANES, resolve_device
from .sparse.dia import DIA
from .sparse.dia_kernels import FusedChebSmoother, KernelDIA
from .sparse.device import ELL
from .smoothers import (ChebyshevSmoother, JacobiSmoother, L1JacobiSmoother,
                        MetricSmoother, MulticolorGS, SchwarzSmoother)
from .smoothers.schwarz import LocalSchwarzSmoother, Rank1SchurSmoother
from .sparse.host import HostCSR


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


def fused_pcg_from_jax(fp, F, device=None) -> FusedPCG:
    """A JAX FusedPCG -> the port's FusedPCG: its cycle (vcycle_from_jax)
    and its float32 outer planes Q4 (blocked (nblocks, nd, rb, 128)) over
    the same offsets, the JAX rows_p padding dropped."""
    vc = vcycle_from_jax(fp.vc, F, device)
    n = vc.nflat
    Q = KernelDIA(fp.offsQ, to_tensor(_level_planes(fp.Q4, n), device),
                  (n, n), 0)
    return FusedPCG(vc, Q)


def _grid_operator(A, device):
    """A JAX DIA (any dtype) -> DIA; a PDIA -> KernelDIA."""
    if hasattr(A, "data2d"):
        return kernel_dia_from_jax(A, device)
    return DIA(A.offsets, to_tensor(np.asarray(A.data), device), A.shape,
               A.nnz)


def _grid_smoother(sm, device):
    name = type(sm).__name__
    args = (sm.lmax, sm.lmin, sm.degree, getattr(sm, "kind", 1))
    if name == "BlockChebyshevSmoother":
        return BlockChebyshevSmoother(to_tensor(sm.blockinv, device),
                                      to_tensor(sm.mask, device), *args)
    if name == "ChebyshevDiagSmoother":
        return ChebyshevDiagSmoother(to_tensor(sm.invd, device),
                                     to_tensor(sm.mask, device), *args)
    if name == "DiaChebyshevSmoother":
        return DiaChebyshevSmoother(_grid_operator(sm.C, device), *args)
    if name == "FusedChebSmoother":
        n = sm.n
        return FusedChebSmoother(
            sm.offsA, to_tensor(_level_planes(sm.dataA4, n), device),
            sm.offsC, to_tensor(_level_planes(sm.dataC4, n), device), n,
            *args)
    raise TypeError(f"no port of the smoother {name}")


def grid_hierarchy_from_jax(prec, device=None) -> MGPreconditioner:
    """The MGPreconditioner of the JAX package's ``amg.grid.setup_grid``
    -> the port's, on the same level operators, smoother data, masks,
    dims and coarse inverse, with the same cycle settings."""
    levels = [GridLevel(_grid_operator(L.A, device),
                        _grid_smoother(L.smoother, device),
                        to_tensor(L.mask, device), L.dims, L.F)
              for L in prec.levels]
    return MGPreconditioner(
        levels, to_tensor(prec.coarse_inv, device), cycle=prec.cycle,
        maxit=prec.maxit, presmooth=prec.presmooth,
        postsmooth=prec.postsmooth, amli_degree=prec.amli_degree,
        max_w_work=prec.max_w_work, coarse_scaling=prec.coarse_scaling)


def ell_from_jax(E, device=None) -> ELL:
    """A JAX ELL -> the port's ELL on the same planes (int64 columns)."""
    cols = to_tensor(np.asarray(E.cols).astype(np.int64), device)
    return ELL(cols, to_tensor(E.vals, device), E.shape, E.nnz)


def _amg_smoother(sm, device):
    name = type(sm).__name__
    if name == "MetricSmoother":
        return MetricSmoother(_amg_smoother(sm.schwarz, device),
                              None if sm.gs is None
                              else _amg_smoother(sm.gs, device))
    if name == "SchwarzSmoother":
        return SchwarzSmoother(
            [to_tensor(np.asarray(i).astype(np.int64), device)
             for i in sm.dof_ids],
            [to_tensor(v, device) for v in sm.inv_blocks],
            symmetric=sm.symmetric, additive=sm.additive,
            weight=float(sm.weight))
    if name == "MulticolorGS":
        return MulticolorGS(
            [ell_from_jax(E, device) for E in sm.color_rows],
            [to_tensor(np.asarray(i).astype(np.int64), device)
             for i in sm.color_ids],
            [to_tensor(d, device) for d in sm.color_invd],
            omega=float(sm.omega), symmetric=sm.symmetric)
    if name in ("JacobiSmoother", "L1JacobiSmoother"):
        cls = JacobiSmoother if name == "JacobiSmoother" else \
            L1JacobiSmoother
        return cls(to_tensor(sm.invd, device), float(sm.omega))
    if name == "ChebyshevSmoother":
        return ChebyshevSmoother(to_tensor(sm.invd, device), float(sm.lmax),
                                 float(sm.lmin), sm.degree)
    raise TypeError(f"no port of the smoother {name}")


def _mg_level_from_jax(L, device):
    agg = None if L.agg is None else to_tensor(
        np.asarray(L.agg).astype(np.int64), device)
    return MGLevel(
        ell_from_jax(L.A, device), _amg_smoother(L.smoother, device),
        agg=agg, P=None if L.P is None else ell_from_jax(L.P, device),
        R=None if L.R is None else ell_from_jax(L.R, device), nc=int(L.nc))


def _like(prec, levels, coarse_inv):
    return MGPreconditioner(
        levels, coarse_inv, cycle=prec.cycle, maxit=prec.maxit,
        presmooth=prec.presmooth, postsmooth=prec.postsmooth,
        amli_degree=prec.amli_degree, max_w_work=prec.max_w_work,
        coarse_scaling=prec.coarse_scaling)


def amg_hierarchy_from_jax(prec, device=None) -> MGPreconditioner:
    """The MGPreconditioner of the JAX package's algebraic
    ``amg.hierarchy.setup_amg`` -> the port's: the same ELL levels, UA
    aggregate maps or SA P/R, smoother data (GS color rows/ids/inverse
    diagonals, Schwarz dof ids and inverse blocks, Jacobi and Chebyshev
    data), coarse inverse and cycle settings."""
    return _like(prec, [_mg_level_from_jax(L, device) for L in prec.levels],
                 to_tensor(prec.coarse_inv, device))


def _structured_operator(A, device):
    """A JAX StructuredOp (its DIA part a DIA or PDIA) -> StructuredOp;
    a DIA or PDIA -> DIA or KernelDIA."""
    if not hasattr(A, "ids"):
        return _grid_operator(A, device)
    spill = None
    if A.spill is not None:
        r, c, v = A.spill
        spill = (to_tensor(np.asarray(r).astype(np.int64), device),
                 to_tensor(np.asarray(c).astype(np.int64), device),
                 to_tensor(v, device))
    return StructuredOp(_grid_operator(A.dia, device),
                        to_tensor(np.asarray(A.ids).astype(np.int64),
                                  device),
                        to_tensor(A.mats, device), nnz=A.nnz, spill=spill)


def _ids(a, device):
    return [to_tensor(np.asarray(t).astype(np.int64), device) for t in a]


def _vals(a, device):
    return [to_tensor(t, device) for t in a]


def _structured_smoother(sm, device):
    name = type(sm).__name__
    if name == "FootprintMetricSmoother":
        return FootprintMetricSmoother(
            _structured_smoother(sm.schwarz, device),
            _structured_smoother(sm.cheb, device))
    if name == "LocalSchwarzSmoother":
        return LocalSchwarzSmoother(
            _ids(sm.dof_ids, device), _vals(sm.inv_blocks, device),
            _ids(sm.row_cols, device), _vals(sm.row_vals, device),
            symmetric=sm.symmetric)
    if name == "Rank1SchurSmoother":
        return Rank1SchurSmoother(
            _ids(sm.dof_ids, device), _vals(sm.dinv, device),
            _vals(sm.w, device), _vals(sm.aseed, device),
            _ids(sm.row_cols, device), _vals(sm.row_vals, device),
            symmetric=sm.symmetric)
    return _grid_smoother(sm, device)


def _level_from_jax(L, device):
    if not hasattr(L, "n_groups"):          # an algebraic tail level
        return _mg_level_from_jax(L, device)
    return StructuredLevel(_structured_operator(L.A, device),
                           _structured_smoother(L.smoother, device),
                           to_tensor(L.mask, device), int(L.s),
                           int(L.n_groups), int(L.nc))


def structured_hierarchy_from_jax(prec, device=None):
    """The JAX package's ``amg.structured.setup_structured`` result -> the
    port's, on the same data.

    An MGPreconditioner of StructuredLevels (and, with a unified
    algebraic tail, the tail's levels after them) becomes the port's:
    level operators as DIA / KernelDIA planes or StructuredOp ids, mats
    and spill; smoothers with their block inverses, masks, lmax/lmin and
    the footprint Schwarz data (LocalSchwarzSmoother,
    Rank1SchurSmoother); transfers' s, n_groups and nc; the coarse
    inverse.  A HostTailHybrid becomes the port's HostTailHybrid: its
    fine part so, its tail through amg_hierarchy_from_jax on the CPU,
    and its boundary operator and coarse_scaling as they are."""
    if hasattr(prec, "tail_apply"):
        Ab = prec._Ab
        return HostTailHybrid(
            structured_hierarchy_from_jax(prec.fine, device),
            amg_hierarchy_from_jax(prec.tail, "cpu"),
            HostCSR(np.asarray(Ab.indptr), np.asarray(Ab.indices),
                    np.asarray(Ab.data), Ab.shape),
            coarse_scaling=prec.coarse_scaling)
    cinv = None if prec.coarse_inv is None else to_tensor(prec.coarse_inv,
                                                          device)
    return _like(prec, [_level_from_jax(L, device) for L in prec.levels],
                 cinv)
