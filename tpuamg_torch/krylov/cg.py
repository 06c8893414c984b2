"""Preconditioned Conjugate Gradient with the diagnostics surface of
cbc.block's ConjGrad, on torch tensors.

Counterpart of the JAX package's ``krylov/cg.py::pcg``: residual history
(B-inner-product norms sqrt(r·z)) plus the true l2 recurrence residual,
Lanczos alpha/beta -> eigenvalue estimates -> condition number, HAZmath's
stop types 1/2/3, and a callback.  The loop runs on the tensors' device
and keeps every scalar there; the host reads the per-iteration statistics
once every ``chunk`` iterations to test convergence.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class CGResult:
    x: object
    niters: int
    converged: bool
    residuals: np.ndarray        # sqrt(r·z) history, length niters+1
    true_residuals: np.ndarray   # ||r||_2 recurrence history
    alphas: np.ndarray
    betas: np.ndarray

    def eigenvalue_estimates(self):
        """Eigenvalue estimates of B·A from the CG Lanczos tridiagonal
        (the cbc.block `eigenvalue_estimates` contract)."""
        k = len(self.alphas)
        if k == 0:
            return np.array([1.0])
        a = np.asarray(self.alphas, dtype=np.float64)
        b = np.asarray(self.betas, dtype=np.float64)
        diag = 1.0 / a
        diag[1:] += b[:-1] / a[:-1]
        off = np.sqrt(np.maximum(b[:-1], 0.0)) / a[:-1]
        return np.linalg.eigvalsh(
            np.diag(diag) + np.diag(off, 1) + np.diag(off, -1))

    @property
    def cond(self):
        ev = self.eigenvalue_estimates()
        lo = ev.min()
        return float(ev.max() / lo) if lo > 0 else float("inf")


_TINY = 1e-300


def _dot(u, v):
    # a reduction kernel, not a BLAS call
    return torch.sum(u * v)


def _norm(u):
    return torch.linalg.vector_norm(u)


def pcg(A, b, M=None, x0=None, tol=1e-8, maxiter=500, callback=None,
        chunk=32, stop_type=2):
    """Solve A x = b with PCG; returns CGResult.

    A, M: callables (matvec) or objects with .matvec.  An A that carries
    ``dots`` (a row-sharded operator, ``dist.dist_kernels.ShardedDIA``)
    supplies the inner products of its vectors: every dot and norm then
    goes through it, two all-reduces over the ranks per iteration, so the
    host reads the same statistics on every rank.

    stop_type selects the convergence test, mirroring HAZmath's
    ``linear_stop_type`` (input_metric.dat:54):
      1 = ||r||_2 / ||b||_2        (STOP_REL_RES)
      2 = ||r||_B / ||r0||_B       (STOP_REL_PRECRES; preconditioned norm)
          — the default
      3 = ||r||_2 / ||x||_2        (STOP_MOD_REL_RES)

    Safe divides (rz / (pAp + tiny)) keep iterations after convergence
    harmless: the history is cut at the first iteration that meets the
    test, and x is the iterate at the end of that chunk.
    """
    Afn = A.matvec if hasattr(A, "matvec") else A
    dots = getattr(A, "dots", None)

    def dot(u, v):
        return _dot(u, v) if dots is None else dots((u, v))[0]

    def rz_norms(r, z, v):
        """r.z, ||r||_2, ||v||_2"""
        if dots is None:
            return _dot(r, z), _norm(r), _norm(v)
        s = dots((r, z), (r, r), (v, v))
        return s[0], torch.sqrt(s[1]), torch.sqrt(s[2])
    Mfn = (M.matvec if hasattr(M, "matvec") else M) if M is not None \
        else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    tiny = _TINY if b.dtype == torch.float64 else 1e-30
    maxiter = int(maxiter)
    chunk = max(1, min(int(chunk), maxiter))
    r = b - Afn(x)
    z = Mfn(r)
    p = z.clone()
    rz, nr, nb = rz_norms(r, z, b)
    init = torch.stack([rz, nr, nb]).double().cpu().numpy()
    res0 = float(np.sqrt(max(init[0], 0.0)))
    res_hist = [res0]
    true_hist = [float(init[1])]
    norm_b = float(init[2]) if stop_type == 1 else 0.0
    alphas, betas = [], []
    k = 0
    if stop_type == 1:
        converged = true_hist[0] <= tol * norm_b or norm_b == 0.0
    else:
        converged = res0 == 0.0

    def _crossed(o):
        if stop_type == 1:
            return o[:, 3] <= tol * norm_b
        if stop_type == 3:
            return o[:, 3] <= tol * np.maximum(o[:, 4], _TINY)
        return o[:, 2] <= tol * res0

    while not converged and k < maxiter:
        n_run = min(chunk, maxiter - k)
        stats = []
        for _ in range(n_run):
            Ap = Afn(p)
            alpha = rz / (dot(p, Ap) + tiny)
            x.add_(alpha * p)
            r.sub_(alpha * Ap)
            z = Mfn(r)
            rz_new, nr, nx = rz_norms(r, z, x)
            beta = rz_new / (rz + tiny)
            p = z + beta * p
            rz = rz_new
            stats.append(torch.stack([alpha, beta, torch.sqrt(rz.abs()),
                                      nr, nx]))
        # one host read per chunk: alpha beta res true xnorm
        o = torch.stack(stats).double().cpu().numpy()
        cross = _crossed(o)
        hit = np.flatnonzero(cross | ~np.isfinite(o[:, 2]))
        take = int(hit[0]) + 1 if len(hit) else n_run
        alphas.extend(o[:take, 0].tolist())
        betas.extend(o[:take, 1].tolist())
        res_hist.extend(o[:take, 2].tolist())
        true_hist.extend(o[:take, 3].tolist())
        k += take
        converged = len(hit) > 0 and np.isfinite(o[hit[0], 2]) \
            and bool(cross[hit[0]])
        if len(hit) and not converged:
            break     # breakdown (non-finite residual): stop, report as-is
    res = np.asarray(res_hist)
    true = np.asarray(true_hist)
    if callback is not None:
        for i in range(1, k + 1):
            callback(i, None, true[i])
    return CGResult(x=x, niters=k, converged=bool(converged),
                    residuals=res, true_residuals=true,
                    alphas=np.asarray(alphas), betas=np.asarray(betas))
