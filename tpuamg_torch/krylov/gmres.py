"""Restarted left-preconditioned GMRES, on torch tensors.

Counterpart of the JAX package's ``krylov/gmres.py``: each restart cycle
builds a fixed-size Arnoldi basis on the device (classical Gram-Schmidt
with one reorthogonalization, CGS2: two (m+1, n) x (n,) products per
step), then the host solves the (m+1, m) Hessenberg least-squares problems
— one per Arnoldi step, for the per-step residual norms — with Givens
rotations.  The residual history is per iteration and ``niters`` is exact
at mid-cycle convergence.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GmresResult:
    x: object
    niters: int
    converged: bool
    residuals: np.ndarray    # preconditioned-residual norm per iteration


def _arnoldi_cycle(A, M, b, x0, restart):
    """One Arnoldi build of size ``restart``: returns (V, H, beta)."""
    n = b.shape[0]
    m = restart
    r = M(b - A(x0))
    beta = torch.linalg.vector_norm(r)
    V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
    H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
    one = torch.ones_like(beta)
    V[0] = r / torch.where(beta > 0, beta, one)
    for j in range(m):
        w = M(A(V[j]))
        mask = (torch.arange(m + 1, device=b.device) <= j).to(b.dtype)
        h1 = (V @ w) * mask
        w = w - V.T @ h1
        h2 = (V @ w) * mask
        w = w - V.T @ h2
        hnorm = torch.linalg.vector_norm(w)
        H[:, j] = h1 + h2
        H[j + 1, j] = hnorm
        V[j + 1] = w / torch.where(hnorm > 0, hnorm, one)
    return V, H, beta


def _hessenberg_residuals(H, beta):
    """Host-side per-step GMRES residual norms via Givens rotations.

    Returns (res[1..m], ys) where res[j-1] = min_y ||beta e1 - H[:j+1,:j] y||
    and ys[j-1] is the minimizer."""
    H = np.asarray(H, dtype=np.float64)
    m = H.shape[1]
    R = H.copy()
    g = np.zeros(m + 1)
    g[0] = beta
    res = np.empty(m)
    ys = []
    rot = []
    for j in range(m):
        for i, (ci, si) in enumerate(rot):   # prior rotations on column j
            t = ci * R[i, j] + si * R[i + 1, j]
            R[i + 1, j] = -si * R[i, j] + ci * R[i + 1, j]
            R[i, j] = t
        d = np.hypot(R[j, j], R[j + 1, j])
        c, s = (1.0, 0.0) if d == 0 else (R[j, j] / d, R[j + 1, j] / d)
        rot.append((c, s))
        R[j, j] = d
        R[j + 1, j] = 0.0
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        res[j] = abs(g[j + 1])
        y = np.zeros(m)
        if d != 0 and not np.any(np.diag(R[:j + 1, :j + 1]) == 0):
            y[:j + 1] = np.linalg.solve(np.triu(R[:j + 1, :j + 1]),
                                        g[:j + 1])
        ys.append(y)
    return res, ys


def gmres(A, b, M=None, x0=None, tol=1e-8, maxiter=500, restart=30):
    """Left-preconditioned restarted GMRES; tolerance is relative on the
    preconditioned residual.  Returns GmresResult with a per-iteration
    residual history and niters exact at mid-cycle convergence."""
    Afn = A.matvec if hasattr(A, "matvec") else A
    Mfn = (M.matvec if hasattr(M, "matvec") else M) if M is not None \
        else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = float(torch.linalg.vector_norm(Mfn(b - Afn(x))))
    residuals = [r0]
    target = tol * max(r0, 1e-300)
    niters = 0
    if r0 <= 0.0:
        return GmresResult(x=x, niters=0, converged=True,
                           residuals=np.asarray(residuals))
    while niters < maxiter:
        m = int(min(restart, maxiter - niters))
        V, H, beta = _arnoldi_cycle(Afn, Mfn, b, x, m)
        res, ys = _hessenberg_residuals(H.double().cpu().numpy(),
                                        float(beta))
        hit = np.flatnonzero(res <= target)
        take = int(hit[0]) + 1 if len(hit) else m
        residuals.extend(res[:take].tolist())
        niters += take
        y_pad = torch.as_tensor(ys[take - 1], dtype=b.dtype).to(b.device)
        x = x + V[:-1].T @ y_pad
        if len(hit):
            return GmresResult(x=x, niters=niters, converged=True,
                               residuals=np.asarray(residuals))
    return GmresResult(x=x, niters=niters, converged=False,
                       residuals=np.asarray(residuals))
