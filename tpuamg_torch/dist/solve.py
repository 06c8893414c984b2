"""Distributed grid solve: the row-sharded grid hierarchy under PCG.

Counterpart of the grid part of the JAX package's ``dist/solve.py``
(``distributed_grid_solve`` and its padding helpers).  The slowest grid
axis is padded with ghost vertices to a multiple of ndev * 2^shard_depth,
so levels 0..shard_depth split into whole axis-0 slabs, one per rank, and
the window transfers between them stay inside each slab; deeper levels
are replicated.  With the kernels (f32/bf16 data), every sharded level's
smoother becomes a ``ShardedChebSmoother`` (K6 per step) and the outer
operator a ``ShardedPDIA`` (K1's padded-x entry).

The algebraic ``distributed_solve`` and ``distributed_pcg_step`` (the ELL
hierarchy of ``amg.hierarchy.setup_amg``, sharded) wait for ROADMAP Queue
1 item 12.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..amg.grid import (ChebyshevDiagSmoother, grid_system, setup_grid,
                        use_kernels)
from ..amg.hierarchy import MGPreconditioner, as_operator
from ..amg.structured import BlockChebyshevSmoother
from ..config import AMGParameters
from ..kernels import LANES
from ..krylov import pcg
from ..problems.solve import _torch_dtype
from ..sparse import HostCSR
from .dist_kernels import ShardedChebSmoother, ShardedPDIA
from .sharding import (ShardedGridLevel, device_mesh, shard_dia,
                       shard_preconditioner, shard_vector)


def _vertex_embedding(dims, dims2):
    """newv[v]: flat vertex index in dims2 of old vertex v (lex order,
    last axis fastest)."""
    nv = int(np.prod(dims))
    coords = []
    rem = np.arange(nv)
    for ax in reversed(range(len(dims))):
        coords.append(rem % dims[ax])
        rem //= dims[ax]
    coords = coords[::-1]
    newv = np.zeros(nv, dtype=np.int64)
    for ax in range(len(dims)):
        newv = newv * dims2[ax] + coords[ax]
    return newv


def pad_grid_problem(A_host: HostCSR, b, dims, F, mult):
    """Append ghost vertices up to per-axis multiples.

    mult: int (axis 0 only) or a per-axis tuple.  A_host/b are
    field-major ([u1-block; u2-block]).  Ghost rows are identity with
    mask 0 (excluded from smoothing and coarse sums).
    Returns (A2, b2, dims2, mask2)."""
    if np.isscalar(mult):
        mults = (int(mult),) + (1,) * (len(dims) - 1)
    else:
        mults = tuple(int(m) for m in mult)
    dims2 = tuple(-(-d // m) * m for d, m in zip(dims, mults))
    nv = int(np.prod(dims))
    if dims2 == tuple(dims):
        return A_host, np.asarray(b, dtype=np.float64), tuple(dims), \
            np.ones(nv * F)
    nv2 = int(np.prod(dims2))
    newv = _vertex_embedding(dims, dims2)
    r, c, v = A_host.to_coo()
    r2 = (r // nv) * nv2 + newv[r % nv]
    c2 = (c // nv) * nv2 + newv[c % nv]
    mask2 = np.zeros(nv2 * F)
    for f in range(F):
        mask2[f * nv2 + newv] = 1.0
    ghosts = np.flatnonzero(mask2 == 0)
    A2 = HostCSR.from_coo(
        np.concatenate([r2, ghosts]), np.concatenate([c2, ghosts]),
        np.concatenate([v, np.ones(len(ghosts))]), (nv2 * F, nv2 * F))
    b2 = np.zeros(nv2 * F)
    bb = np.asarray(b, dtype=np.float64)
    for f in range(F):
        b2[f * nv2 + newv] = bb[f * nv:(f + 1) * nv]
    return A2, b2, dims2, mask2


def unpad_grid_vector(x2, dims, dims2, F):
    """Inverse of pad_grid_problem's vector embedding."""
    nv = int(np.prod(dims))
    nv2 = int(np.prod(dims2))
    if nv == nv2:
        return np.asarray(x2)
    newv = _vertex_embedding(dims, dims2)
    x = np.empty(nv * F)
    x2 = np.asarray(x2)
    for f in range(F):
        x[f * nv:(f + 1) * nv] = x2[f * nv2 + newv]
    return x


def _dist_pallas_mults(dims, F, ndev, shard_depth, pallas_levels=None):
    """Per-axis padding multiples, kept as the JAX package computes them
    (they fix the padded grid, and with it the hierarchy, nflat and the
    iteration counts): axis 0 divisible by ndev*2^shard_depth and each
    of the first pallas_levels levels' flat length divisible by
    128*8*ndev (the TPU kernels' row-block layout; level l dims halve l
    times).  Greedy: doubles the multiple of whichever axis grows the
    padded volume least.

    pallas_levels=None selects depth automatically: the padded volume
    budget is set by the 2-level solution, and the deepest
    nlv <= shard_depth + 1 whose solution fits that budget wins."""
    need = LANES * 8 * ndev
    mults = [ndev * 2 ** shard_depth] + [1] * (len(dims) - 1)

    def ok(ms, nlv):
        d2 = [-(-d // m) * m for d, m in zip(dims, ms)]
        for _ in range(nlv):
            if (int(np.prod(d2)) * F) % need:
                return False
            d2 = [(d + 1) // 2 for d in d2]
        return True

    def nflat(ms):
        return int(np.prod([-(-d // m) * m
                            for d, m in zip(dims, ms)])) * F

    def solve_depth(nlv, cap):
        trial = list(mults)
        for _ in range(64):
            if ok(trial, nlv):
                return trial
            if nflat(trial) > cap:
                return None    # padding blow-up at this depth
            best, bi = None, 0
            for i in range(len(dims)):
                t = list(trial)
                t[i] *= 2
                cost = nflat(t) / nflat(trial)
                if best is None or cost < best:
                    best, bi = cost, i
            trial[bi] *= 2
        return None

    if pallas_levels is not None:
        for nlv in range(pallas_levels, 0, -1):
            got = solve_depth(nlv, 4 * nflat(mults))
            if got is not None:
                return tuple(got)
        raise ValueError("cannot satisfy sharded-Pallas divisibility")
    base = None
    for nlv in range(min(2, shard_depth + 1), 0, -1):
        base = solve_depth(nlv, 4 * nflat(mults))
        if base is not None:
            break
    if base is None:
        raise ValueError("cannot satisfy sharded-Pallas divisibility")
    budget = nflat(base)
    chosen = base
    for nlv in range(shard_depth + 1, 2, -1):   # deepest free depth wins
        got = solve_depth(nlv, budget)
        if got is not None and nflat(got) <= budget:
            chosen = got
            break
    return tuple(chosen)


def _upgrade_pallas_levels(prec, mesh, n_shard_min):
    """Swap every sharded level's Chebyshev smoother for
    ShardedChebSmoother (K6).  The JAX package keeps its XLA smoother on a
    level whose halo is wider than a shard, a rule of its neighbour-only
    halo exchange; the port's ``_exchange`` gathers such a halo, so every
    level takes K6.  Returns (prec, number of levels upgraded)."""
    levels = []
    n_up = 0
    for L in prec.levels:
        sm = L.smoother
        if (isinstance(L, ShardedGridLevel) and L.A.shape[0] >= n_shard_min
                and isinstance(sm, (BlockChebyshevSmoother,
                                    ChebyshevDiagSmoother))):
            if isinstance(sm, BlockChebyshevSmoother):
                bi = sm.blockinv.double().cpu().numpy()
            else:
                bi = sm.invd.double().cpu().numpy().reshape(-1, 1, 1)
            sm2 = ShardedChebSmoother.build(
                L.A, bi, sm.mask.double().cpu().numpy(), sm.lmax, sm.lmin,
                sm.degree, mesh, kind=sm.kind)
            levels.append(L.with_smoother(sm2))
            n_up += 1
            continue
        levels.append(L)
    prec2 = MGPreconditioner(
        tuple(levels), prec.coarse_inv, cycle=prec.cycle,
        maxit=prec.maxit, presmooth=prec.presmooth,
        postsmooth=prec.postsmooth, amli_degree=prec.amli_degree,
        max_w_work=prec.max_w_work, coarse_scaling=prec.coarse_scaling)
    return prec2, n_up


@dataclass
class DistGridProblem:
    """What setup_distributed_grid builds on each rank: the sharded
    hierarchy ``prec``, the outer operator ``A`` and this rank's slab
    ``b`` of the padded, field-interleaved right-hand side, with what it
    takes to map a solution back (``slots``, ``dims``, ``dims2``, ``F``)
    and the JAX ``dist_info`` numbers (``info``)."""
    prec: MGPreconditioner
    A: object
    b: torch.Tensor
    slots: np.ndarray
    dims: tuple
    dims2: tuple
    F: int
    mesh: object
    info: dict

    def solve(self, tol=1e-8, maxiter=500):
        """PCG on the mesh; the result's x is the whole solution, in the
        caller's dof order, on every rank: the crossing iterate
        (krylov.pcg)."""
        res = pcg(self.A, self.b, M=as_operator(self.prec), tol=tol,
                  maxiter=maxiter)
        x2 = self.mesh.all_gather(res.x).double().cpu().numpy()[self.slots]
        res.x = unpad_grid_vector(x2, self.dims, self.dims2, self.F)
        res.dist_info = dict(self.info)
        return res


def setup_distributed_grid(A_host: HostCSR, b, dims, F=1,
                           params: AMGParameters = None, mesh=None,
                           dtype=torch.float32, shard_depth=3,
                           cheb_degree=3, pallas=None, device=None):
    """The set-up half of distributed_grid_solve (same arguments):
    returns a DistGridProblem."""
    if mesh is None:
        mesh = device_mesh(device)
    ndev = mesh.size
    dt = _torch_dtype(dtype)
    use_k = use_kernels(pallas, dt)
    if params is None:
        params = AMGParameters(cycle_type="v",
                               dtype=str(dt).replace("torch.", ""))
    mults = ndev * 2 ** shard_depth
    if use_k:
        # the JAX package pads level 0 to its kernels' layout; the padding
        # shapes the hierarchy, so it stays for parity.  Where that layout
        # cannot be met, the JAX package pads as it does without kernels,
        # and so does the port, which keeps its kernels: they need no
        # layout
        try:
            mults = _dist_pallas_mults(dims, F, ndev, shard_depth,
                                       pallas_levels=1)
        except ValueError:
            pass
    A2, b2, dims2, mask2 = pad_grid_problem(A_host, b, dims, F, mults)
    # levels deeper than shard_depth are replicated
    n_sd = int(np.prod([-(-d // 2 ** shard_depth) for d in dims2])) * F
    prec, slots, nsl = setup_grid(A2, dims2, F=F, mask=mask2, params=params,
                                  dtype=dt, cheb_degree=cheb_degree,
                                  pallas=False, device=mesh.device)
    prec = shard_preconditioner(prec, mesh, replicate_below=n_sd)
    Adia = grid_system(A2, slots, dtype=dt, pallas=False,
                       device=mesh.device)
    n_up = 0
    n_shardable = sum(1 for L in prec.levels if L.A.shape[0] >= n_sd)
    if use_k:
        prec, n_up = _upgrade_pallas_levels(prec, mesh, n_sd)
        Aop = ShardedPDIA.from_dia(Adia, mesh)
    else:
        Aop = shard_dia(Adia, mesh)
    bj = torch.zeros(nsl, dtype=dt)
    bj[torch.as_tensor(slots)] = torch.as_tensor(b2, dtype=dt)
    info = {"ndev": ndev, "nflat": nsl, "levels": len(prec.levels),
            "sharded_levels": n_shardable, "pallas_levels": n_up,
            "outer_pallas": isinstance(Aop, ShardedPDIA)}
    return DistGridProblem(prec, Aop, shard_vector(bj, mesh), slots,
                           tuple(dims), tuple(dims2), F, mesh, info)


def distributed_grid_solve(A_host: HostCSR, b, dims, F=1,
                           params: AMGParameters = None, mesh=None,
                           tol=1e-8, maxiter=500, dtype=torch.float32,
                           shard_depth=3, cheb_degree=3, pallas=None,
                           device=None):
    """Row-sharded grid-hierarchy PCG over the mesh's ranks.

    Every rank calls it with the same arguments (the whole system); each
    builds the hierarchy on the host, keeps its slab of levels
    0..shard_depth and the whole of the deeper ones, and runs PCG on its
    slab with all-reduced dots.  Returns (CGResult, mesh); the result's x
    is the whole solution, on every rank, and ``dist_info`` holds ndev,
    nflat, levels, sharded_levels, pallas_levels and outer_pallas.

    pallas: None / True / False, the rule of amg.grid.use_kernels: with
    the kernels, ShardedChebSmoother (K6) on every sharded level and
    ShardedPDIA (K1's padded-x entry) for the outer operator; otherwise
    plain torch ops throughout.
    mesh: a sharding.DeviceMesh (None = device_mesh(device)); device:
    None = this rank's card, "cpu" with a gloo group."""
    prob = setup_distributed_grid(A_host, b, dims, F, params, mesh, dtype,
                                  shard_depth, cheb_degree, pallas, device)
    return prob.solve(tol, maxiter), prob.mesh
