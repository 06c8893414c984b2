"""Preconditioned MINRES for symmetric (indefinite) systems, on torch
tensors.

Counterpart of the JAX package's ``krylov/minres.py``: the Paige–Saunders
recurrence with a symmetric positive preconditioner, run in chunks of
iterations whose scalars stay on the device; the host reads the
per-iteration statistics (phibar, alpha, beta) once per chunk, cuts the
history at the first iteration that meets the tolerance, and returns that
iteration's iterate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class MinresResult:
    x: object
    niters: int
    converged: bool
    residuals: np.ndarray
    alphas: np.ndarray = None    # Lanczos diagonal (preconditioned op)
    betas: np.ndarray = None     # Lanczos off-diagonal beta_{k+1}
    executed: int = 0            # iterations run (M ran once more)
    host_reads: int = 0          # reads of the device's statistics

    def eigenvalue_estimates(self):
        """Eigenvalue estimates of M*A from the MINRES Lanczos
        tridiagonal (the CGResult diagnostics contract)."""
        if self.alphas is None or len(self.alphas) == 0:
            return np.array([1.0])
        a = np.asarray(self.alphas, dtype=np.float64)
        b = np.asarray(self.betas, dtype=np.float64)[:len(a) - 1]
        return np.linalg.eigvalsh(
            np.diag(a) + np.diag(b, 1) + np.diag(b, -1))

    @property
    def cond(self):
        ev = np.abs(self.eigenvalue_estimates())
        lo = ev.min()
        return float(ev.max() / lo) if lo > 0 else float("inf")


def _dot(u, v):
    return torch.sum(u * v)


def _minres_chunk(A, M, state, chunk):
    """`chunk` MINRES iterations; returns the state and the (chunk, 3)
    statistics phibar, alpha, beta on the device."""
    (x, r1, r2, y, beta, betaold, dbar, epsln, phibar_, cs, sn,
     w, w2) = state
    tiny = torch.tensor(1e-300 if r2.dtype == torch.float64 else 1e-30,
                        dtype=r2.dtype, device=r2.device)
    outs = []
    for _ in range(chunk):
        beta_safe = torch.maximum(beta, tiny)
        v = y / beta_safe
        yk = A(v)
        yk = yk - (beta / torch.maximum(betaold, tiny)) * r1
        alfa = _dot(v, yk)
        yk = yk - (alfa / beta_safe) * r2
        r1, r2 = r2, yk
        y = M(r2)
        betaold = beta
        beta = torch.sqrt(torch.clamp(_dot(r2, y), min=0))
        # apply the previous rotation
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.maximum(torch.sqrt(gbar ** 2 + beta ** 2), tiny)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar_
        phibar_ = sn * phibar_
        w1 = w2
        w2 = w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        outs.append(torch.stack([phibar_, alfa, beta]))
    state = (x, r1, r2, y, beta, betaold, dbar, epsln, phibar_, cs, sn,
             w, w2)
    return state, torch.stack(outs)


def minres(A, b, M=None, x0=None, tol=1e-8, maxiter=500, chunk=32):
    """Solve the symmetric system A x = b with preconditioned MINRES;
    returns MinresResult.  The host reads the statistics once per chunk
    and returns the iterate of the first iteration whose phibar meets
    ``tol * phibar_0``: chunk lengths come from phibar's contraction
    (``krylov.cg.next_chunk``, at most ``chunk``), and a chunk that runs
    past the crossing is run again from its saved start up to it, so
    ``executed`` is bounded as krylov.cg.pcg's is."""
    from .cg import next_chunk
    Afn = A.matvec if hasattr(A, "matvec") else A
    Mfn = (M.matvec if hasattr(M, "matvec") else M) if M is not None \
        else (lambda r: r)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = int(maxiter)
    chunk = max(1, min(int(chunk), maxiter))

    r2 = b - Afn(x0)
    # the first Lanczos step has no r1 correction: start r1 = 0 so the
    # (beta/betaold) * r1 term vanishes at k=0
    r1 = torch.zeros_like(r2)
    y = Mfn(r2)
    beta = torch.sqrt(torch.clamp(_dot(r2, y), min=0))
    res0 = float(beta)

    def scalar(v):
        return torch.tensor(v, dtype=b.dtype, device=b.device)
    zero = scalar(0.0)
    state = (x0, r1, r2, y, beta, scalar(1.0), zero, zero, beta,
             scalar(-1.0), zero, torch.zeros_like(b), torch.zeros_like(b))
    res_hist = [res0]
    alphas, betas = [], []
    k = executed = 0
    reads = 1
    converged = res0 == 0.0
    n_run = 1
    while not converged and k < maxiter:
        n_run = next_chunk(res_hist, tol * res0, min(chunk, maxiter - k),
                           n_run) if k else 1
        # the chunk's start (the chunk makes new tensors, but y may be
        # M's own buffer), kept to rerun it up to a crossing inside it
        saved = state[:3] + (state[3].clone(),) + state[4:] \
            if n_run > 1 else None
        state, outs = _minres_chunk(Afn, Mfn, state, n_run)
        executed += n_run
        o = outs.double().cpu().numpy()   # (n_run, 3): phibar alfa betan
        reads += 1
        ph = o[:, 0]
        hit = np.flatnonzero((ph <= tol * res0) | ~np.isfinite(ph))
        take = int(hit[0]) + 1 if len(hit) else n_run
        take = min(take, maxiter - k)
        converged = len(hit) > 0 and np.isfinite(ph[hit[0]]) \
            and ph[hit[0]] <= tol * res0
        if converged and take < n_run and saved is not None:
            state, _ = _minres_chunk(Afn, Mfn, saved, take)
            executed += take
        res_hist.extend(ph[:take].tolist())
        alphas.extend(o[:take, 1].tolist())
        betas.extend(o[:take, 2].tolist())
        k += take
        if len(hit) and not converged:
            break
    return MinresResult(x=state[0], niters=k, converged=bool(converged),
                        residuals=np.asarray(res_hist),
                        alphas=np.asarray(alphas),
                        betas=np.asarray(betas), executed=executed,
                        host_reads=reads)
