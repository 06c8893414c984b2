"""Preconditioned Conjugate Gradient with the diagnostics surface of
cbc.block's ConjGrad, on torch tensors.

Counterpart of the JAX package's ``krylov/cg.py::pcg``: residual history
(B-inner-product norms sqrt(r·z)) plus the true l2 recurrence residual,
Lanczos alpha/beta -> eigenvalue estimates -> condition number, HAZmath's
stop types 1/2/3, and a callback.  The loop runs on the tensors' device
and keeps every scalar there; the host reads the per-iteration statistics
once per chunk to test convergence, and returns the iterate of the first
iteration that meets the test.

``pcg_split`` is the counterpart of the JAX package's PCG over a split
V-cycle with a host step (the structured path's host tail): per iteration
the device runs the outer matvec, the x/r updates and the fine levels
down to the coarse boundary; the host applies the float64 tail to the
boundary residual; the device prolongs back up and completes the CG
recurrence.
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
    executed: int = 0            # iterations run (M ran once more: z0)
    host_reads: int = 0          # reads of the device's statistics

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


def next_chunk(q, target, cap, last=1):
    """Iterations to run before the next host read, from the tested
    quantity's history q (q[0] at the solve's start, q[-1] now; the last
    ``last`` entries are the last chunk's).  The contraction rate is the
    fastest of three: the whole history's, the last chunk's and the last
    four iterations' (convergence speeds up as CG goes on).  The chunk is
    half the iterations that rate needs to reach ``target``, rounded
    down, at least 1 and at most ``cap`` and the iterations run so far.
    Without a target (0): ``cap``; without a contraction: the last
    chunk's length."""
    if not target > 0:
        return cap
    q = np.asarray(q, dtype=np.float64)
    k = len(q) - 1
    if k < 1 or not np.all(np.isfinite(q)) or q[-1] <= 0:
        return 1
    rate = np.inf
    for m in {k, last, min(4, last, k)}:
        if 0 < m <= k and q[-1 - m] > 0:
            rate = min(rate, np.log(q[-1] / q[-1 - m]) / m)
    if not rate < 0:
        return max(1, min(cap, last, k))
    left = np.log(target / q[-1]) / rate
    return int(max(1, min(cap, k, np.floor(0.5 * left))))


def pcg(A, b, M=None, x0=None, tol=1e-8, maxiter=500, callback=None,
        chunk=32, stop_type=2):
    """Solve A x = b with PCG; returns CGResult.

    A, M: callables (matvec) or objects with .matvec.  An A that carries
    ``dots`` (a row-sharded operator, ``dist.dist_kernels.ShardedDIA``)
    supplies the inner products of its vectors: every dot and norm then
    goes through it, two all-reduces over the ranks per iteration, so the
    host reads the same statistics on every rank (and every rank picks
    the same chunk lengths).

    stop_type selects the convergence test, mirroring HAZmath's
    ``linear_stop_type`` (input_metric.dat:54):
      1 = ||r||_2 / ||b||_2        (STOP_REL_RES)
      2 = ||r||_B / ||r0||_B       (STOP_REL_PRECRES; preconditioned norm)
          — the default
      3 = ||r||_2 / ||x||_2        (STOP_MOD_REL_RES)

    The host reads the per-iteration statistics once per chunk, cuts the
    history at the first iteration that meets the test and returns that
    iteration's x (the crossing iterate).  Chunk lengths come from the
    tested quantity's contraction (``next_chunk``), at most ``chunk``, so
    a chunk rarely runs past the crossing; one that does is run again
    from its saved start (x, r, p, z, rz) up to the crossing.  The
    result's ``executed`` counts the iterations run (the preconditioner
    ran once more, for z0) and ``host_reads`` the reads.  executed is
    niters, or niters + n when one chunk of n iterations ran past the
    crossing and was run again; n is at most ``chunk`` and at most the
    iterations run before that chunk (``next_chunk``).  A non-finite
    residual stops the solve at the end of its chunk.
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
    k = executed = 0
    reads = 1
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

    # the tested quantity's history and its target, for the chunk lengths
    if stop_type == 1:
        tested, target = true_hist, tol * norm_b
    elif stop_type == 3:
        tested, target = [], tol        # ||r|| / ||x||, from iteration 1
    else:
        tested, target = res_hist, tol * res0

    def run(state, n):
        """n iterations from state = (x, r, p, z, rz); x, r and p are
        never updated in place, so a saved state stays valid."""
        x, r, p, z, rz = state
        stats = []
        for _ in range(n):
            Ap = Afn(p)
            alpha = rz / (dot(p, Ap) + tiny)
            x = x + alpha * p
            r = r - alpha * Ap
            z = Mfn(r)
            rz_new, nr, nx = rz_norms(r, z, x)
            beta = rz_new / (rz + tiny)
            p = z + beta * p
            rz = rz_new
            stats.append(torch.stack([alpha, beta, torch.sqrt(rz.abs()),
                                      nr, nx]))
        return (x, r, p, z, rz), stats

    state = (x, r, p, z, rz)
    n_run = 1
    while not converged and k < maxiter:
        cap = min(chunk, maxiter - k)
        n_run = next_chunk(tested, target, cap, n_run) if k else 1
        # the chunk's start, kept to rerun it up to a crossing inside it
        saved = state[:3] + (state[3].clone(), state[4]) \
            if n_run > 1 else None
        state, stats = run(state, n_run)
        executed += n_run
        # one host read per chunk: alpha beta res true xnorm
        o = torch.stack(stats).double().cpu().numpy()
        reads += 1
        cross = _crossed(o)
        hit = np.flatnonzero(cross | ~np.isfinite(o[:, 2]))
        take = int(hit[0]) + 1 if len(hit) else n_run
        converged = len(hit) > 0 and np.isfinite(o[hit[0], 2]) \
            and bool(cross[hit[0]])
        if converged and take < n_run and saved is not None:
            state, _ = run(saved, take)     # back to the crossing iterate
            executed += take
        alphas.extend(o[:take, 0].tolist())
        betas.extend(o[:take, 1].tolist())
        res_hist.extend(o[:take, 2].tolist())
        true_hist.extend(o[:take, 3].tolist())
        if stop_type == 3:
            tested.extend((o[:take, 3] / np.maximum(o[:take, 4], _TINY)
                           ).tolist())
        k += take
        if len(hit) and not converged:
            break     # breakdown (non-finite residual): stop, report as-is
    res = np.asarray(res_hist)
    true = np.asarray(true_hist)
    if callback is not None:
        for i in range(1, k + 1):
            callback(i, None, true[i])
    return CGResult(x=state[0], niters=k, converged=bool(converged),
                    residuals=res, true_residuals=true,
                    alphas=np.asarray(alphas), betas=np.asarray(betas),
                    executed=executed, host_reads=reads)


def pcg_split(A, b, fine, tail_apply, x0=None, tol=1e-8, maxiter=500,
              callback=None, stop_type=2, ec_dtype=None):
    """PCG whose preconditioner is a split V-cycle with a HOST step.

    Per iteration: Ap, alpha, x and r on the device, ``fine.cycle_down(r)``
    to the coarse boundary; one device-to-host copy of the boundary
    residual rc; ``tail_apply(rc)`` on the host (numpy float64 in and
    out); one upload of ec; ``fine.cycle_up`` and the CG update on the
    device; then one read of the iteration's statistics (alpha, beta,
    sqrt(r.z), ||r||, ||x||) to test convergence.  Numerically pcg with
    chunk=1 over the unified hybrid for cycle='v', maxit=1.

    fine: MGPreconditioner of the device levels (cycle_down / cycle_up;
    it may have none).  tail_apply: host callable rc -> ec in float64.
    ec_dtype: upload dtype of ec (default the boundary residual's dtype,
    which the unified cycle casts it to anyway).  Returns CGResult, with
    executed = niters (the loop reads every iteration) and host_reads
    counting the statistics reads."""
    Afn = A.matvec if hasattr(A, "matvec") else A
    if x0 is None:
        x0 = torch.zeros_like(b)
    tiny = _TINY if b.dtype == torch.float64 else 1e-30
    maxiter = int(maxiter)

    def tail(rc):
        nonlocal ec_dtype
        if ec_dtype is None:
            ec_dtype = rc.dtype
        ec = tail_apply(rc.double().cpu().numpy())
        return torch.as_tensor(np.asarray(ec), dtype=ec_dtype).to(rc.device)

    def up(carry, ec, r):
        z = fine.cycle_up(carry, ec).to(r.dtype)
        return z, _dot(r, z)

    r = b - Afn(x0)
    carry, rc = fine.cycle_down(r)
    z, rz = up(carry, tail(rc), r)
    p = z
    x = x0
    init = torch.stack([rz, _norm(r), _norm(b)]).double().cpu().numpy()
    reads = 1
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
    while not converged and k < maxiter:
        Ap = Afn(p)
        alpha = rz / (_dot(p, Ap) + tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        carry, rc = fine.cycle_down(r)
        z, rz_new = up(carry, tail(rc), r)
        beta = rz_new / (rz + tiny)
        p = z + beta * p
        rz = rz_new
        o = torch.stack([alpha.to(r.dtype), beta, torch.sqrt(rz.abs()),
                         _norm(r), _norm(x)]).double().cpu().numpy()
        reads += 1
        if not np.isfinite(o[2]):
            break               # breakdown: stop, report as-is
        alphas.append(o[0])
        betas.append(o[1])
        res_hist.append(o[2])
        true_hist.append(o[3])
        k += 1
        if stop_type == 1:
            converged = o[3] <= tol * norm_b
        elif stop_type == 3:
            converged = o[3] <= tol * max(o[4], _TINY)
        else:
            converged = o[2] <= tol * res0
    true = np.asarray(true_hist)
    if callback is not None:
        for i in range(1, k + 1):
            callback(i, None, true[i])
    return CGResult(x=x, niters=k, converged=bool(converged),
                    residuals=np.asarray(res_hist), true_residuals=true,
                    alphas=np.asarray(alphas), betas=np.asarray(betas),
                    executed=k, host_reads=reads)
