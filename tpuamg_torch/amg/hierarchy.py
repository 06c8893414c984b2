"""Multilevel cycle driver: the step-by-step reference preconditioner.

Counterpart of the JAX package's ``amg/hierarchy.py::MGPreconditioner``
and ``as_operator``.  The levels are duck-typed: each has an operator
``A`` (``matvec``/``residual``/``dtype``), a ``smoother`` (``smooth``, and
optionally ``smooth_residual``, which fuses the pre-smoothing with the
residual), ``restrict``/``prolong`` and the coarse size ``nc``.  The grid
path (``amg/grid.py``) and the fused hierarchy's reference
(``amg/grid_fused.py::setup_grid_fused(reference=True)``) build them.

Cycle types: V, W, AMLI(degree), nonlinear AMLI, additive and full
multigrid (``fmg`` with V, ``fmg_w`` with W inner cycles) — HAZmath's
``cycle_type``.  W/AMLI recursion degrades to V below the depth where the
recursive visit count would pass ``max_w_work``.  Every cycle runs on the
tensors' device in torch ops; the scalars of AMLI and coarse scaling stay
there (``torch.where``), so a cycle never waits for the host.  Their inner
products go through the level operator's ``dots`` where it has them (a
row-sharded level's, which all-reduce over the ranks).

The algebraic set-up (``setup_amg``) builds ``MGLevel`` levels on the
host — strength graph, aggregation, UA or SA transfers, Galerkin coarse
operators, the level smoothers (multicolor GS, Jacobi, Chebyshev, interface
Schwarz) and a float64 dense coarse inverse — and ships them to the device
as ELL matrices and index tensors.

The split application (``cycle_down`` / ``cycle_up``) runs a V-cycle
(maxit=1, zero initial guess) in two halves around a coarse boundary, so
that the structured path's host-tail hybrid
(``amg.structured.HostTailHybrid``, driven by ``krylov.cg.pcg_split``)
can run the coarse tail on the host between them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import AMGParameters
from ..kernels import resolve_device
from ..sparse.device import ELL
from ..sparse.host import HostCSR, pad_csr_identity, rap_unsmoothed
from ..smoothers import (build_jacobi, build_l1_jacobi, build_multicolor_gs,
                         build_chebyshev, MetricSmoother)
from .aggregation import AGGREGATORS, hem_aggregation, mwm_aggregation
from .prolongation import tentative_prolongator, smoothed_prolongator
from .strength import strength_graph


def _vdot(u, v):
    return torch.dot(u.reshape(-1), v.reshape(-1))


def _dot_of(A):
    """The inner product of a level's vectors: through the operator's
    ``dots`` where it has them (a row-sharded operator all-reduces over
    the ranks), else _vdot."""
    dots = getattr(A, "dots", None)
    if dots is None:
        return _vdot
    return lambda u, v: dots((u, v))[0]


class MGLevel:
    """One algebraic level: the fine operator (ELL), its smoother and the
    transfer to the next level — the aggregate map ``agg`` (UA: restrict
    is a scatter-add, prolong a gather) or the ELL matrices ``P``/``R``
    (SA).  ``nc`` is the coarse size."""

    def __init__(self, A: ELL, smoother, agg=None, P=None, R=None, nc=0):
        self.A = A
        self.smoother = smoother
        self.agg = agg      # (n,) int64 aggregate map (UA transfers)
        self.P = P          # ELL (SA) or None
        self.R = R          # ELL (SA) or None
        self.nc = nc

    def restrict(self, r):
        if self.agg is not None:
            return torch.zeros(self.nc, dtype=r.dtype,
                               device=r.device).index_add_(0, self.agg, r)
        return self.R.matvec(r)

    def prolong(self, ec):
        if self.agg is not None:
            return ec[self.agg]
        return self.P.matvec(ec)

    def to(self, device):
        def mv(t):
            return None if t is None else t.to(device)
        return MGLevel(self.A.to(device), self.smoother.to(device),
                       mv(self.agg), mv(self.P), mv(self.R), self.nc)


class MGPreconditioner:
    """Multilevel cycle as a linear operator (``matvec``)."""

    def __init__(self, levels, coarse_inv, cycle="v", maxit=1,
                 presmooth=1, postsmooth=1, amli_degree=3, max_w_work=256,
                 coarse_scaling=False):
        self.levels = tuple(levels)
        self.coarse_inv = coarse_inv
        self.cycle = cycle
        self.maxit = maxit
        self.presmooth = presmooth
        self.postsmooth = postsmooth
        self.amli_degree = amli_degree
        self.max_w_work = max_w_work
        # HAZmath AMG_coarse_scaling: energy-minimizing scaling of each
        # coarse correction, alpha = <rc,ec>/<ec,Ac ec> clipped to [0, 2]
        # (1 where the denominator is not positive).  Makes the
        # preconditioner mildly nonlinear, as HAZmath applies it under
        # plain PCG.
        self.coarse_scaling = coarse_scaling

    # -- application --------------------------------------------------
    def _coarse_solve(self, b):
        return self.coarse_inv.to(b.dtype) @ b

    def _n_recursive(self, lvl):
        """Recursive visits of level lvl in a pure W/AMLI cycle."""
        mu = 2 if self.cycle in ("w", "fmg_w") else (
            self.amli_degree if self.cycle in ("amli", "nl_amli") else 1)
        return mu ** lvl

    @staticmethod
    def _level_dtype(L):
        # the level's compute dtype: GridLevel keeps it beside its (maybe
        # narrower) storage; other levels compute in their operator's
        return getattr(L, "dtype", None) or getattr(L.A, "dtype", None)

    def _cycle(self, lvl, b, x):
        if lvl == len(self.levels):
            return self._coarse_solve(b)
        L = self.levels[lvl]
        ldt = self._level_dtype(L)
        if ldt is not None and b.dtype != ldt:
            b = b.to(ldt)
            x = x.to(ldt)
        if hasattr(L.smoother, "smooth_residual"):
            # pre-smoothing and residual in one sweep
            x, r = L.smoother.smooth_residual(L.A, x, b, self.presmooth)
        else:
            x = L.smoother.smooth(L.A, x, b, self.presmooth)
            r = L.A.residual(x, b)
        rc = L.restrict(r)
        ec = torch.zeros(L.nc, dtype=b.dtype, device=b.device)
        if self.cycle in ("w", "fmg_w") and \
                self._n_recursive(lvl + 1) <= self.max_w_work:
            ec = self._cycle(lvl + 1, rc, ec)
            ec = self._cycle(lvl + 1, rc, ec)
        elif self.cycle in ("amli", "nl_amli") and \
                self._n_recursive(lvl + 1) <= self.max_w_work:
            ec = self._amli_inner(lvl + 1, rc, ec)
        else:   # v (or degraded deep levels)
            ec = self._cycle(lvl + 1, rc, ec)
        ec = ec.to(b.dtype)
        if self.coarse_scaling and lvl + 1 < len(self.levels):
            Ac = self.levels[lvl + 1].A
            dot = _dot_of(Ac)
            denom = dot(ec, Ac.matvec(ec))
            num = dot(rc, ec)
            alpha = torch.where(
                denom > 0, torch.clamp(num / (denom + 1e-300), 0.0, 2.0),
                torch.ones_like(denom))
            ec = alpha * ec
        x = x + L.prolong(ec)
        x = L.smoother.smooth(L.A, x, b, self.postsmooth, reverse=True)
        return x

    def _amli_inner(self, lvl, b, x):
        """Nonlinear AMLI: `amli_degree` steps of flexible steepest descent
        on the coarse problem, preconditioned by the recursive cycle."""
        if lvl == len(self.levels):
            return self._coarse_solve(b)
        A = self.levels[lvl].A
        dot = _dot_of(A)
        for _ in range(self.amli_degree):
            r = A.residual(x, b)
            z = self._cycle(lvl, r, torch.zeros_like(r))
            Az = A.matvec(z)
            denom = dot(z, Az)
            alpha = torch.where(denom > 0, dot(z, r) / denom,
                                torch.ones_like(denom))
            x = x + alpha * z
        return x

    def _fmg(self, b):
        """Full-multigrid (F-cycle) application: restrict the rhs through
        every level, coarse-solve first, then work upward — at each level
        prolong the current solution and run one cycle with the restricted
        rhs."""
        rs = [b]
        for L in self.levels:
            rs.append(L.restrict(rs[-1]))
        x = self._coarse_solve(rs[-1])
        for i in reversed(range(len(self.levels))):
            x = self.levels[i].prolong(x)
            x = self._cycle(i, rs[i], x)
        return x

    def _additive(self, b):
        """Additive (BPX-like) cycle: smoother contributions from every
        level plus the coarse solve, summed."""
        rs = [b]
        for L in self.levels:
            rs.append(L.restrict(rs[-1]))
        ec = self._coarse_solve(rs[-1])
        for i in reversed(range(len(self.levels))):
            L = self.levels[i]
            z = L.smoother.smooth(L.A, torch.zeros_like(rs[i]), rs[i], 1)
            ec = z + L.prolong(ec)
        return ec

    # -- split application (host-tail hybrids) ------------------------
    # For cycle='v', cycle_up(carry, tail(rc)) equals matvec(b) exactly
    # when the tail preconditioner equals the levels this object would
    # hold below the boundary (same recursion, zero initial coarse guess).
    def cycle_down(self, b):
        """Pre-smooth and restrict through every level.

        Returns (carry, rc): carry = the per-level (x, b) tuples for
        cycle_up, rc = the residual restricted to the coarse boundary
        (the tail's level-0 size)."""
        xs, bs = [], []
        for L in self.levels:
            ldt = self._level_dtype(L)
            if ldt is not None and b.dtype != ldt:
                b = b.to(ldt)
            x = torch.zeros_like(b)
            if hasattr(L.smoother, "smooth_residual"):
                x, r = L.smoother.smooth_residual(L.A, x, b,
                                                  self.presmooth)
            else:
                x = L.smoother.smooth(L.A, x, b, self.presmooth)
                r = L.A.residual(x, b)
            xs.append(x)
            bs.append(b)
            b = L.restrict(r)
        return (tuple(xs), tuple(bs)), b

    def cycle_up(self, carry, ec):
        """Prolong and post-smooth back up from the coarse correction."""
        xs, bs = carry
        for i in reversed(range(len(self.levels))):
            L = self.levels[i]
            b, x = bs[i], xs[i]
            ec = ec.to(b.dtype)
            if self.coarse_scaling and i + 1 < len(self.levels):
                Ac = self.levels[i + 1].A
                dot = _dot_of(Ac)
                rc = bs[i + 1]
                denom = dot(ec, Ac.matvec(ec))
                num = dot(rc, ec)
                alpha = torch.where(
                    denom > 0,
                    torch.clamp(num / (denom + 1e-300), 0.0, 2.0),
                    torch.ones_like(denom))
                ec = alpha * ec
            x = x + L.prolong(ec)
            x = L.smoother.smooth(L.A, x, b, self.postsmooth,
                                  reverse=True)
            ec = x
        return ec

    def matvec(self, b):
        if self.cycle == "add":
            return self._additive(b).to(b.dtype)
        if self.cycle in ("fmg", "fmg_w"):
            # FMG once, then (maxit-1) cycles refine from it
            x = self._fmg(b)
            for _ in range(self.maxit - 1):
                x = self._cycle(0, b, x)
            return x.to(b.dtype)
        x = torch.zeros_like(b)
        for _ in range(self.maxit):
            x = self._cycle(0, b, x)
        # keep the Krylov iteration's dtype even if hierarchy data is wider
        return x.to(b.dtype)

    def to(self, device):
        """The same hierarchy on another device (levels with ``to``)."""
        return MGPreconditioner(
            [L.to(device) for L in self.levels],
            self.coarse_inv.to(device), cycle=self.cycle, maxit=self.maxit,
            presmooth=self.presmooth, postsmooth=self.postsmooth,
            amli_degree=self.amli_degree, max_w_work=self.max_w_work,
            coarse_scaling=self.coarse_scaling)


def as_operator(prec: MGPreconditioner):
    """The preconditioner as a krylov-compatible callable."""
    return prec.matvec


# ---------------------------------------------------------------------------
# Algebraic set-up
# ---------------------------------------------------------------------------

def _build_level_smoother(A: HostCSR, params: AMGParameters, level,
                          idofs, dtype, device):
    if level < params.schwarz_levels:
        # Blocks are *seeded* at interface dofs but grow through the full
        # matrix graph: the gamma*M coupling reaches the partner dofs
        # outside the interface set, and block solves must capture that
        # pair coupling for gamma-robustness.
        from ..smoothers.schwarz_setup import build_schwarz_fast
        schwarz = build_schwarz_fast(
            A, idofs=idofs if idofs is not None
            else np.arange(A.shape[0]),
            maxlvl=params.schwarz_maxlvl,
            mmsize=params.schwarz_mmsize,
            symmetric=(params.schwarz_type == "symmetric"),
            dtype=dtype, cluster=params.schwarz_cluster, device=device)
        if idofs is not None and len(idofs) < A.shape[0]:
            # the complement smoother (GS elsewhere, reference utils.py:84);
            # smoother="chebyshev" takes masked Chebyshev, which is exactly
            # Chebyshev on the complement block
            mask = np.ones(A.shape[0], dtype=bool)
            mask[idofs] = False
            if params.smoother == "chebyshev":
                gs = build_chebyshev(A, degree=3, active=mask, dtype=dtype,
                                     device=device)
            else:
                gs = build_multicolor_gs(
                    A, omega=1.0, symmetric=False, active=mask,
                    max_colors=params.gs_max_colors, dtype=dtype,
                    device=device)
        else:
            gs = None
        return MetricSmoother(schwarz, gs)
    sm = params.smoother
    kw = dict(dtype=dtype, device=device)
    if sm == "jacobi":
        return build_jacobi(A, omega=1.0 / params.relaxation, **kw)
    if sm == "l1_jacobi":
        return build_l1_jacobi(A, **kw)
    if sm == "chebyshev":
        return build_chebyshev(A, degree=3, **kw)
    mc = params.gs_max_colors
    if sm == "gs":
        return build_multicolor_gs(A, omega=1.0, symmetric=False,
                                   max_colors=mc, **kw)
    if sm == "sor":      # HAZmath SOR = GS with relaxation weight
        return build_multicolor_gs(A, omega=params.relaxation,
                                   symmetric=False, max_colors=mc, **kw)
    if sm == "ssor":
        return build_multicolor_gs(A, omega=params.relaxation,
                                   symmetric=True, max_colors=mc, **kw)
    # default sgs
    return build_multicolor_gs(A, omega=1.0, symmetric=True, max_colors=mc,
                               **kw)


def _batch_isolated_rows(A: HostCSR, agg, nagg, max_aggregation):
    """Merge aggregates of off-diagonal-free rows into batches."""
    r, c, _ = A.to_coo()
    offdeg = np.zeros(A.shape[0], dtype=np.int64)
    np.add.at(offdeg, r[r != c], 1)
    iso = np.flatnonzero(offdeg == 0)
    if len(iso) < 2:
        return agg, nagg
    group = max(2, int(max_aggregation))
    new_ids = nagg + np.arange(len(iso)) // group
    agg = agg.copy()
    agg[iso] = new_ids
    used, inv = np.unique(agg[agg >= 0], return_inverse=True)
    out = np.full(len(agg), -1, dtype=np.int64)
    out[agg >= 0] = inv
    return out, len(used)


def setup_amg(A_host: HostCSR, params: AMGParameters = AMGParameters(),
              idofs=None, pad_multiple=1, device=None) -> MGPreconditioner:
    """Build the algebraic multilevel hierarchy on the host and ship it
    to the device (None = the CUDA card, "cpu" = the plain versions).

    idofs: interface dof indices — rows that get the Schwarz treatment on
    Schwarz-enabled levels (metricAMG semantics, reference
    utils.py:86-88), carried to coarse levels through the aggregate map.

    pad_multiple: pad every level's row count to this multiple with inert
    identity rows (row sharding over a device mesh); callers pad the RHS
    to match."""
    dev = resolve_device(device)
    dtype = torch.float64 if params.dtype == "float64" else torch.float32
    aggregate = AGGREGATORS[params.aggregation_type]
    levels = []
    A = pad_csr_identity(A_host, pad_multiple)
    cur_idofs = None if idofs is None else np.asarray(idofs, dtype=np.int64)
    while (len(levels) < params.max_levels - 1
           and A.shape[0] > params.coarse_dof):
        # UA coarse operators grow their diagonal with aggregate size, so a
        # fixed strength threshold starves the strength graph on coarse
        # levels: decay theta per level, as HAZmath does on coarse grids.
        theta = params.strong_coupled * (0.5 ** len(levels))
        S = strength_graph(A, theta)
        if params.aggregation_type in ("hem", "mwm"):
            # pairwise matchings coarsen by <=2x per pass; compose passes
            pair = (hem_aggregation if params.aggregation_type == "hem"
                    else mwm_aggregation)
            agg, nagg = pair(S)
            for _ in range(params.pairwise_passes - 1):
                if nagg <= params.coarse_dof:
                    break
                Ac_tmp = rap_unsmoothed(A, agg, nagg)
                S2 = strength_graph(Ac_tmp, theta)
                agg2, nagg2 = pair(S2)
                agg = agg2[agg]
                nagg = nagg2
        else:
            agg, nagg = aggregate(S, params.max_aggregation)
        # Rows with no off-diagonal coupling (eliminated Dirichlet rows)
        # never aggregate and would stall coarsening as singletons: batch
        # them into group aggregates (one pre-smoothing solves them
        # exactly, so their coarse correction never activates).
        agg, nagg = _batch_isolated_rows(A, agg, nagg,
                                         params.max_aggregation)
        if nagg > 0.85 * A.shape[0]:   # stagnation — dense-solve the rest
            break
        smoother = _build_level_smoother(A, params, len(levels), cur_idofs,
                                         dtype, dev)
        if params.amg_type == "sa":
            if pad_multiple != 1:
                raise NotImplementedError(
                    "pad_multiple with SA transfers (UA only)")
            P_t = tentative_prolongator(agg, nagg)
            P = smoothed_prolongator(A, P_t, params.strong_coupled)
            R = P.T
            Ac = R.matmat(A.matmat(P))
            levels.append(MGLevel(
                ELL.from_host(A, dtype=dtype, device=dev), smoother,
                P=ELL.from_host(P, dtype=dtype, device=dev),
                R=ELL.from_host(R, dtype=dtype, device=dev), nc=nagg))
        else:
            Ac = pad_csr_identity(rap_unsmoothed(A, agg, nagg),
                                  pad_multiple)
            levels.append(MGLevel(
                ELL.from_host(A, dtype=dtype, device=dev), smoother,
                agg=torch.as_tensor(agg, dtype=torch.int64).to(dev),
                nc=Ac.shape[0]))
        if cur_idofs is not None:
            cur_idofs = np.unique(agg[cur_idofs])
            cur_idofs = cur_idofs[cur_idofs >= 0]
        A = Ac
    # the coarse inverse in float64 on the host, stored in the level dtype
    coarse_inv = np.linalg.inv(A.toarray()) if A.shape[0] > 0 else \
        np.zeros((0, 0))
    return MGPreconditioner(
        levels, torch.as_tensor(coarse_inv, dtype=dtype).to(dev),
        cycle=params.cycle_type, maxit=params.maxit,
        presmooth=params.presmooth_iter, postsmooth=params.postsmooth_iter,
        amli_degree=params.amli_degree, max_w_work=params.max_w_work,
        coarse_scaling=params.coarse_scaling)
