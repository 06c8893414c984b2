"""Pointwise relaxation smoothers on ELL matrices, as torch ops.

Counterpart of the JAX package's ``smoothers/relaxation.py``: HAZmath's
smoother menu (JACOBI/GS/SGS/SOR/SSOR/L1DIAG, reference
amg_parameters.py:9):

- (weighted/l1-)Jacobi: one SpMV and an axpy per sweep.
- Multicolor Gauss-Seidel / symmetric GS: exact GS up to row ordering —
  the rows are colored on the host at setup, and each color's update is
  a partial SpMV over its rows and a scatter-add into x at its (unique)
  row ids.  Rows past ``gs_max_colors`` share one overflow group, damped
  l1-Jacobi style.
- Chebyshev: the 3-term polynomial smoother on D^{-1}A, with the largest
  eigenvalue from a host power iteration at setup.

Each smoother has ``smooth(A, x, b, iters=1, reverse=False) -> x``, which
leaves the caller's x as it was.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import resolve_device
from ..sparse.device import ELL
from ..sparse.host import HostCSR, greedy_color


def _tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


class JacobiSmoother:
    def __init__(self, invd, omega=1.0):
        self.invd = invd
        self.omega = omega

    def smooth(self, A: ELL, x, b, iters=1, reverse=False):
        for _ in range(iters):
            x = x + self.omega * self.invd * (b - A.matvec(x))
        return x

    def to(self, device):
        return type(self)(self.invd.to(device), self.omega)


class L1JacobiSmoother(JacobiSmoother):
    """Jacobi with the l1 diagonal  d_i = sum_j |a_ij|  — unconditionally
    convergent for SPD A; the reference's L1DIAG option."""


def build_jacobi(A_host: HostCSR, omega=1.0, dtype=torch.float32,
                 device=None):
    d = A_host.diagonal()
    return JacobiSmoother(_tensor(1.0 / d, dtype, resolve_device(device)),
                          omega)


def build_l1_jacobi(A_host: HostCSR, dtype=torch.float32, device=None):
    r, c, v = A_host.to_coo()
    l1 = np.zeros(A_host.shape[0])
    np.add.at(l1, r, np.abs(v))
    return L1JacobiSmoother(_tensor(1.0 / l1, dtype,
                                    resolve_device(device)), 1.0)


class MulticolorGS:
    """Multicolor (symmetric) Gauss-Seidel.

    color_rows[c]: ELL slice of A's rows for color c.
    color_ids[c]: row indices of color c (int64, unique).
    color_invd[c]: 1/diag for those rows (l1 norms in the overflow group).
    """

    def __init__(self, color_rows, color_ids, color_invd, omega=1.0,
                 symmetric=True):
        self.color_rows = tuple(color_rows)
        self.color_ids = tuple(color_ids)
        self.color_invd = tuple(color_invd)
        self.omega = omega
        self.symmetric = symmetric

    def _half_sweep(self, x, b, order):
        # x is this sweep's own copy: the updates go in place; a color's
        # ids are unique, so each entry takes one add, as x.at[ids].add
        for c in order:
            Ac, ids, invd = (self.color_rows[c], self.color_ids[c],
                             self.color_invd[c])
            r = b[ids] - Ac.matvec(x)
            x.index_add_(0, ids, self.omega * invd * r)
        return x

    def smooth(self, A: ELL, x, b, iters=1, reverse=False):
        ncol = len(self.color_rows)
        fwd = tuple(range(ncol))
        if reverse and not self.symmetric:
            fwd = fwd[::-1]   # transpose sweep: keeps the cycle symmetric
        x = x.clone()
        for _ in range(iters):
            x = self._half_sweep(x, b, fwd)
            if self.symmetric:
                x = self._half_sweep(x, b, fwd[::-1])
        return x

    def to(self, device):
        return MulticolorGS([r.to(device) for r in self.color_rows],
                            [i.to(device) for i in self.color_ids],
                            [d.to(device) for d in self.color_invd],
                            self.omega, self.symmetric)


def build_multicolor_gs(A_host: HostCSR, omega=1.0, symmetric=True,
                        active=None, max_colors=24, dtype=torch.float32,
                        device=None):
    """active: optional bool mask / index set — only these rows are updated
    (the metric smoother's GS on the non-interface dofs, reference
    utils.py:84).

    Rows in the overflow color group (see greedy_color) may share edges;
    they get l1-diagonal damping instead of 1/diag, which keeps the sweep
    convergent for SPD A whatever the group topology."""
    dev = resolve_device(device)
    colors = greedy_color(A_host, max_colors=max_colors)
    d = A_host.diagonal()
    overflow = int(colors.max()) == max_colors
    if overflow:
        r, _, v = A_host.to_coo()
        l1 = np.zeros(A_host.shape[0])
        np.add.at(l1, r, np.abs(v))
    ncol = int(colors.max()) + 1
    act = np.ones(A_host.shape[0], dtype=bool)
    if active is not None:
        active = np.asarray(active)
        if active.dtype == bool:
            act = active
        else:
            act[:] = False
            act[active] = True
    rows, ids_l, invd_l = [], [], []
    for c in range(ncol):
        ids = np.flatnonzero((colors == c) & act)
        if len(ids) == 0:
            continue
        rows.append(ELL.from_host(slice_rows(A_host, ids), dtype=dtype,
                                  device=dev))
        ids_l.append(_tensor(ids, torch.int64, dev))
        scale = d[ids] if not (overflow and c == max_colors) else l1[ids]
        invd_l.append(_tensor(1.0 / scale, dtype, dev))
    return MulticolorGS(rows, ids_l, invd_l, omega, symmetric)


def slice_rows(A: HostCSR, ids) -> HostCSR:
    """A[ids, :] as a new HostCSR (vectorized)."""
    rank = np.full(A.shape[0], -1, dtype=np.int64)
    rank[np.asarray(ids)] = np.arange(len(ids))
    r, c, v = A.to_coo()
    m = rank[r] >= 0
    return HostCSR.from_coo(rank[r[m]], c[m], v[m],
                            (len(ids), A.shape[1]), sum_duplicates=False)


class ChebyshevSmoother:
    """Chebyshev polynomial smoother on D^{-1}A over [lmax/ratio, lmax]."""

    def __init__(self, invd, lmax, lmin, degree=3):
        self.invd = invd
        self.lmax = lmax
        self.lmin = lmin
        self.degree = degree

    def smooth(self, A: ELL, x, b, iters=1, reverse=False):
        # standard 3-term Chebyshev iteration (Saad) on D^{-1}A
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma1 = theta / delta
        for _ in range(iters):
            rho = 1.0 / sigma1
            r = self.invd * (b - A.matvec(x))
            d = r / theta
            for _k in range(1, self.degree):
                x = x + d
                r = self.invd * (b - A.matvec(x))
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = rho_new * rho * d + (2.0 * rho_new / delta) * r
                rho = rho_new
            x = x + d
        return x

    def to(self, device):
        return ChebyshevSmoother(self.invd.to(device), self.lmax, self.lmin,
                                 self.degree)


def estimate_lmax_dinv_a(A_host: HostCSR, iters=20, seed=0, invd=None):
    """Power iteration for rho(D^{-1} A) on host (invd: optional
    masked/custom inverse diagonal)."""
    rng = np.random.default_rng(seed)
    if invd is None:
        invd = 1.0 / A_host.diagonal()
    x = rng.standard_normal(A_host.shape[0]) * (invd != 0)
    lam = 1.0
    for _ in range(iters):
        y = A_host.matvec(x) * invd
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


def build_chebyshev(A_host: HostCSR, degree=3, ratio=8.0,
                    dtype=torch.float32, active=None, device=None):
    """active: optional bool mask / index set — updates are restricted
    to these rows (zero inverse diagonal elsewhere), which makes the
    sweep exactly Chebyshev on the principal submatrix A[act, act] (the
    masked rows of x never change, so the masked residual is the
    submatrix residual)."""
    d = A_host.diagonal()
    invd = 1.0 / d
    if active is not None:
        act = np.asarray(active)
        if act.dtype != bool:
            m = np.zeros(A_host.shape[0], dtype=bool)
            m[act] = True
            act = m
        invd = np.where(act, invd, 0.0)
    lmax = 1.1 * estimate_lmax_dinv_a(A_host, invd=invd)
    return ChebyshevSmoother(_tensor(invd, dtype, resolve_device(device)),
                             lmax, lmax / ratio, degree)
