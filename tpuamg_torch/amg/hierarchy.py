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

The split application of the host-tail hybrids (``cycle_down`` /
``cycle_up``) is ROADMAP Queue 1 item 9 and is not here yet.
"""
from __future__ import annotations

import torch


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


def as_operator(prec: MGPreconditioner):
    """The preconditioner as a krylov-compatible callable."""
    return prec.matvec
