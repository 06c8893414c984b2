"""Overlapping Schwarz block smoother, batched, as torch ops.

Counterpart of the JAX package's ``smoothers/schwarz.py``: HAZmath's
Schwarz method (parameters ``Schwarz_levels/mmsize/maxlvl/type/blksolver``,
reference amg_parameters.py:39-43; ``input_metric.dat`` precond type 16 =
symmetric multiplicative Schwarz on interface dofs + GS elsewhere,
reference utils.py:84).

- blocks are grown ``maxlvl`` graph levels from seed dofs, capped at
  ``mmsize`` rows, on the host at setup;
- per-block solves are dense inverses, precomputed on the host, padded to
  one size (identity, or zeros, in the padding) and applied as ONE batched
  (nb, m, m) x (nb, m) product per color;
- the multiplicative ordering colors the blocks by overlap: blocks of one
  color share no dof, so a color's update is one gather of the residual at
  its padded ids and one scatter-add (``index_add_``) into x.  The padding
  points at the ghost slot n of an (n+1)-long buffer, which alone takes
  duplicate adds and is then dropped; symmetric = forward colors, then
  reversed.

``MetricSmoother`` composes Schwarz on the interface dofs with multicolor
GS on the rest — the paper's metric-AMG smoother split.

``LocalSchwarzSmoother`` and ``Rank1SchurSmoother`` are the structured
3D-1D path's footprint smoothers (``amg.structured.setup_structured``):
each color's residual comes from that color's block ROWS only (padded row
extracts ``row_cols``/``row_vals``), never from a whole-level residual.
``DiagRank1Smoother`` is not ported (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import resolve_device
from ..sparse.host import HostCSR


def _bfs_blocks(A: HostCSR, seeds, maxlvl, mmsize, restrict=None):
    """Grow one block per seed: all dofs within graph distance `maxlvl`,
    optionally restricted to the dof set `restrict`; capped at mmsize."""
    indptr, indices = A.indptr, A.indices
    allowed = None
    if restrict is not None:
        allowed = np.zeros(A.shape[0], dtype=bool)
        allowed[restrict] = True
    blocks = []
    for s in seeds:
        frontier = [int(s)]
        seen = {int(s)}
        for _ in range(maxlvl):
            nxt = []
            for u in frontier:
                for vtx in indices[indptr[u]:indptr[u + 1]]:
                    vtx = int(vtx)
                    if vtx in seen:
                        continue
                    if allowed is not None and not allowed[vtx]:
                        continue
                    seen.add(vtx)
                    nxt.append(vtx)
                    if len(seen) >= mmsize:
                        break
                if len(seen) >= mmsize:
                    break
            frontier = nxt
            if len(seen) >= mmsize:
                break
        blocks.append(np.fromiter(sorted(seen), dtype=np.int64))
    return blocks


def _thin_seeds(A: HostCSR, idofs, maxlvl):
    """Covering independent set: greedy distance-(maxlvl) MIS over the
    idofs-induced subgraph, guaranteeing every idof lands in some block."""
    idofs = np.asarray(idofs, dtype=np.int64)
    in_set = np.zeros(A.shape[0], dtype=bool)
    in_set[idofs] = True
    indptr, indices = A.indptr, A.indices
    covered = np.zeros(A.shape[0], dtype=bool)
    seeds = []
    for s in idofs:
        if covered[s]:
            continue
        seeds.append(s)
        # mark distance-maxlvl neighborhood (within idofs) as covered
        frontier = [int(s)]
        covered[s] = True
        for _ in range(maxlvl):
            nxt = []
            for u in frontier:
                for vtx in indices[indptr[u]:indptr[u + 1]]:
                    vtx = int(vtx)
                    if in_set[vtx] and not covered[vtx]:
                        covered[vtx] = True
                        nxt.append(vtx)
            frontier = nxt
    return np.asarray(seeds, dtype=np.int64)


def _color_blocks(blocks, n):
    """Greedy coloring of the block overlap graph (shared dof = edge)."""
    owner = [[] for _ in range(n)]
    for bi, blk in enumerate(blocks):
        for d in blk:
            owner[d].append(bi)
    colors = np.full(len(blocks), -1, dtype=np.int64)
    for bi in range(len(blocks)):
        used = set()
        for d in blocks[bi]:
            for bj in owner[d]:
                if bj != bi and colors[bj] >= 0:
                    used.add(int(colors[bj]))
        c = 0
        while c in used:
            c += 1
        colors[bi] = c
    return colors


class SchwarzSmoother:
    """Colored multiplicative (or additive) overlapping Schwarz.

    Per color c:
      dof_ids[c]:  (nb_c, m) int64, padded with n (the ghost row),
      inv_blocks[c]: (nb_c, m, m) dense inverses.
    """

    def __init__(self, dof_ids, inv_blocks, symmetric=True, additive=False,
                 weight=1.0):
        self.dof_ids = tuple(dof_ids)
        self.inv_blocks = tuple(inv_blocks)
        self.symmetric = symmetric
        self.additive = additive
        self.weight = weight

    def _scatter(self, xpad, c, rpad):
        """xpad[ids] += weight * inv @ rpad[ids] for color c, in place."""
        ids = self.dof_ids[c]
        delta = torch.bmm(self.inv_blocks[c],
                          rpad[ids].unsqueeze(-1)).squeeze(-1)
        xpad.index_add_(0, ids.reshape(-1),
                        (self.weight * delta).reshape(-1))

    def _color_update(self, A, x, b, c):
        rpad = _pad(b - A.matvec(x))
        xpad = _pad(x)
        self._scatter(xpad, c, rpad)
        return xpad[:-1]

    def smooth(self, A, x, b, iters=1, reverse=False):
        ncol = len(self.dof_ids)
        for _ in range(iters):
            if self.additive:
                rpad = _pad(b - A.matvec(x))
                xpad = _pad(x)
                for c in range(ncol):
                    self._scatter(xpad, c, rpad)
                x = xpad[:-1]
            else:
                order = list(range(ncol))
                if reverse and not self.symmetric:
                    order = order[::-1]
                for c in order:
                    x = self._color_update(A, x, b, c)
                if self.symmetric:
                    for c in reversed(range(ncol)):
                        x = self._color_update(A, x, b, c)
        return x

    def to(self, device):
        return SchwarzSmoother([i.to(device) for i in self.dof_ids],
                               [v.to(device) for v in self.inv_blocks],
                               self.symmetric, self.additive, self.weight)


def _pad(v):
    return torch.cat([v, v.new_zeros(1)])


def build_schwarz(A_host: HostCSR, seeds=None, idofs=None, maxlvl=1,
                  mmsize=100, symmetric=True, additive=False,
                  thin=True, restrict_to_idofs=True, weight=1.0,
                  dtype=torch.float32, device=None):
    """Construct the Schwarz smoother data from the host matrix.

    idofs: dof set the smoother acts on (interface dofs); None = all.
    seeds: explicit seed dofs; default = thinned covering MIS of idofs.
    """
    dev = resolve_device(device)
    n = A_host.shape[0]
    if idofs is None:
        idofs = np.arange(n, dtype=np.int64)
    idofs = np.asarray(idofs, dtype=np.int64)
    if seeds is None:
        seeds = _thin_seeds(A_host, idofs, maxlvl) if thin else idofs
    restrict = idofs if restrict_to_idofs else None
    blocks = _bfs_blocks(A_host, seeds, maxlvl, mmsize, restrict)
    colors = _color_blocks(blocks, n)
    ncol = int(colors.max()) + 1 if len(blocks) else 0
    m = max((len(b) for b in blocks), default=1)
    dof_ids, inv_blocks = [], []
    for c in range(ncol):
        bids = [blocks[i] for i in np.flatnonzero(colors == c)]
        nb = len(bids)
        ids = np.full((nb, m), n, dtype=np.int64)      # ghost pad
        inv = np.zeros((nb, m, m), dtype=np.float64)
        for k, blk in enumerate(bids):
            sz = len(blk)
            ids[k, :sz] = blk
            sub = A_host.extract_submatrix(blk, blk)
            inv[k, :sz, :sz] = np.linalg.inv(sub)
        dof_ids.append(torch.as_tensor(ids).to(dev))
        inv_blocks.append(torch.as_tensor(inv, dtype=dtype).to(dev))
    return SchwarzSmoother(dof_ids, inv_blocks, symmetric, additive, weight)


class MetricSmoother:
    """Schwarz on interface dofs + multicolor GS on the rest, applied
    symmetrically: GS-forward, Schwarz(sym), GS-backward.  HAZmath precond
    type 16 semantics (interface Schwarz + GS elsewhere, reference
    input_metric.dat:57, utils.py:84)."""

    def __init__(self, schwarz: SchwarzSmoother, gs):
        self.schwarz = schwarz
        self.gs = gs

    def smooth(self, A, x, b, iters=1, reverse=False):
        for _ in range(iters):
            if self.gs is not None:
                x = self.gs.smooth(A, x, b, reverse=reverse)
            x = self.schwarz.smooth(A, x, b, reverse=reverse)
            if self.gs is not None:
                x = self.gs.smooth(A, x, b, reverse=not reverse)
        return x

    def to(self, device):
        return MetricSmoother(self.schwarz.to(device),
                              None if self.gs is None
                              else self.gs.to(device))


class LocalSchwarzSmoother:
    """Colored multiplicative Schwarz with LOCAL residuals.

    Each color carries batched dense extracts of its block ROWS of A
    (row_cols/row_vals, padded with the ghost column n), so one color
    update is

        r_loc  = b[ids] - sum_k row_vals * x[row_cols]      (local rows)
        x[ids] += inv_blocks @ r_loc                        (batched bmm)

    a few torch ops per color whatever the level operator's matvec costs.
    Blocks of one color are disjoint (overlap coloring), so the scatter
    (``index_add_`` through the ghost slot) is conflict-free;
    symmetric = forward colors then reversed."""

    def __init__(self, dof_ids, inv_blocks, row_cols, row_vals,
                 symmetric=True):
        self.dof_ids = tuple(dof_ids)        # per color: (nb, m) int64
        self.inv_blocks = tuple(inv_blocks)  # per color: (nb, m, m)
        self.row_cols = tuple(row_cols)      # per color: (nb, m, K) int64
        self.row_vals = tuple(row_vals)      # per color: (nb, m, K)
        self.symmetric = symmetric

    def _local_residual(self, xpad, b, c):
        bpad = _pad(b)
        ax = torch.sum(self.row_vals[c].to(xpad.dtype)
                       * xpad[self.row_cols[c]], dim=-1)
        return bpad[self.dof_ids[c]] - ax

    def _color_update(self, x, b, c):
        xpad = _pad(x)
        r = self._local_residual(xpad, b, c)
        delta = torch.bmm(self.inv_blocks[c].to(r.dtype),
                          r.unsqueeze(-1)).squeeze(-1)
        xpad.index_add_(0, self.dof_ids[c].reshape(-1),
                        delta.reshape(-1).to(x.dtype))
        return xpad[:-1]

    def smooth(self, A, x, b, iters=1, reverse=False):
        del A, reverse
        ncol = len(self.dof_ids)
        for _ in range(iters):
            for c in range(ncol):
                x = self._color_update(x, b, c)
            if self.symmetric:
                for c in reversed(range(ncol)):
                    x = self._color_update(x, b, c)
        return x


def _block_rows(A_host: HostCSR, bids, n, m, K):
    """Padded row extracts of the blocks' rows: (ids, row_cols, row_vals)
    with ids (nb, m) and the rows (nb, m, K), padded with the ghost n."""
    indptr, indices, data = A_host.indptr, A_host.indices, A_host.data
    nb = len(bids)
    ids = np.full((nb, m), n, dtype=np.int64)
    rcols = np.full((nb, m, K), n, dtype=np.int64)
    rvals = np.zeros((nb, m, K))
    for k, blk in enumerate(bids):
        ids[k, :len(blk)] = blk
        for t, i in enumerate(blk):
            lo, hi = indptr[i], indptr[i + 1]
            rcols[k, t, :hi - lo] = indices[lo:hi]
            rvals[k, t, :hi - lo] = data[lo:hi]
    return ids, rcols, rvals


def _row_width(A_host: HostCSR, blocks):
    indptr = A_host.indptr
    return int(max((indptr[i + 1] - indptr[i] for blk in blocks
                    for i in blk), default=1))


def build_local_schwarz(A_host: HostCSR, seeds, maxlvl=1, mmsize=200,
                        symmetric=True, dtype=torch.float32,
                        cluster=False, device=None):
    """LocalSchwarzSmoother from the host matrix: blocks = maxlvl-balls
    around the seeds, exact dense inverses (float64 on the host, stored in
    dtype), per-color padded row data.

    cluster=True merges runs of overlapping balls into shared blocks
    (schwarz_setup.merge_overlapping_blocks): at curve resolutions finer
    than the bulk mesh, per-seed footprints coincide."""
    dev = resolve_device(device)
    n = A_host.shape[0]
    blocks = _bfs_blocks(A_host, np.asarray(seeds, dtype=np.int64),
                         maxlvl, mmsize)
    if cluster:
        from .schwarz_setup import merge_overlapping_blocks
        blocks = merge_overlapping_blocks(blocks, mmsize)
    colors = _color_blocks(blocks, n)
    ncol = int(colors.max()) + 1 if len(blocks) else 0
    m = max((len(b) for b in blocks), default=1)
    K = _row_width(A_host, blocks)
    ids_c, inv_c, rc_c, rv_c = [], [], [], []
    for c in range(ncol):
        bids = [blocks[i] for i in np.flatnonzero(colors == c)]
        ids, rcols, rvals = _block_rows(A_host, bids, n, m, K)
        inv = np.zeros((len(bids), m, m))
        for k, blk in enumerate(bids):
            inv[k, :len(blk), :len(blk)] = np.linalg.inv(
                A_host.extract_submatrix(blk, blk))
        ids_c.append(torch.as_tensor(ids).to(dev))
        inv_c.append(torch.as_tensor(inv, dtype=dtype).to(dev))
        rc_c.append(torch.as_tensor(rcols).to(dev))
        rv_c.append(torch.as_tensor(rvals, dtype=dtype).to(dev))
    return LocalSchwarzSmoother(ids_c, inv_c, rc_c, rv_c, symmetric)


class Rank1SchurSmoother:
    """Footprint smoother with O(|footprint|) storage per block.

    Each block (seed curve dof s + footprint f) is solved with the
    structured approximation

        B = [[a, w^T], [w, E]],   E = D_l1 + w w^T / a

    (a = A[s,s], w = A[s,f], D_l1 the l1 row sums), whose inverse applies
    in O(m) by Sherman-Morrison (t = w^T D^{-1} w, denom = a + t):

        alpha   = (denom r_s - a w^T D^{-1} r_f) / a^2
        delta_f = D^{-1} v - D^{-1} w (w^T D^{-1} v) / denom,
        v = r - w alpha,   delta_s = alpha

    with the same colored-multiplicative machinery (local residuals from
    padded row data) as LocalSchwarzSmoother; dof_ids[:, 0] is the seed.
    The JAX package's docstring records its measured limits: gamma-robust
    to ~1e4, not at gamma >= 1e8."""

    def __init__(self, dof_ids, dinv, w, aseed, row_cols, row_vals,
                 symmetric=True):
        self.dof_ids = tuple(dof_ids)        # per color: (nb, m)
        self.dinv = tuple(dinv)              # per color: (nb, m); [.,0]=0
        self.w = tuple(w)                    # per color: (nb, m); [.,0]=0
        self.aseed = tuple(aseed)            # per color: (nb,)
        self.row_cols = tuple(row_cols)      # per color: (nb, m, K)
        self.row_vals = tuple(row_vals)
        self.symmetric = symmetric

    _local_residual = LocalSchwarzSmoother._local_residual

    def _color_update(self, x, b, c):
        xpad = _pad(x)
        r = self._local_residual(xpad, b, c)
        dinv, w, a = (t.to(r.dtype) for t in (self.dinv[c], self.w[c],
                                               self.aseed[c]))
        t = torch.sum(w * dinv * w, dim=1)
        denom = a + t
        wdr = torch.sum(w * dinv * r, dim=1)
        alpha = (denom * r[:, 0] - a * wdr) / (a * a)
        v = r - w * alpha[:, None]
        wdv = wdr - t * alpha             # = sum(w*dinv*v)
        delta = dinv * v - (dinv * w) * (wdv / denom)[:, None]
        delta[:, 0] = alpha
        xpad.index_add_(0, self.dof_ids[c].reshape(-1),
                        delta.reshape(-1).to(x.dtype))
        return xpad[:-1]

    smooth = LocalSchwarzSmoother.smooth


def build_rank1_schur(A_host: HostCSR, seeds, maxlvl=1, mmsize=200,
                      symmetric=True, dtype=torch.float32, device=None):
    """Rank1SchurSmoother from the host matrix (blocks = maxlvl-balls
    around the seeds, seed first, per-color padded row data)."""
    dev = resolve_device(device)
    n = A_host.shape[0]
    seeds = np.asarray(seeds, dtype=np.int64)
    blocks = _bfs_blocks(A_host, seeds, maxlvl, mmsize)
    blocks = [np.concatenate([[s], blk[blk != s]])
              for s, blk in zip(seeds, blocks)]
    colors = _color_blocks(blocks, n)
    ncol = int(colors.max()) + 1 if len(blocks) else 0
    m = max((len(b) for b in blocks), default=1)
    indptr, indices, data = A_host.indptr, A_host.indices, A_host.data
    K = _row_width(A_host, blocks)
    diag = A_host.diagonal()
    # l1 row sums: D_l1 >= A in the SPD sense, so the footprint part of
    # the approximate block solve cannot overshoot
    l1 = np.zeros(n)
    np.add.at(l1, np.repeat(np.arange(n), np.diff(indptr)),
              np.abs(data))
    ids_c, di_c, w_c, sh_c, rc_c, rv_c = [], [], [], [], [], []
    for c in range(ncol):
        bids = [blocks[i] for i in np.flatnonzero(colors == c)]
        nb = len(bids)
        ids, rcols, rvals = _block_rows(A_host, bids, n, m, K)
        dinv = np.zeros((nb, m))
        w = np.zeros((nb, m))
        aseed = np.ones(nb)
        for k, blk in enumerate(bids):
            sz = len(blk)
            s = blk[0]
            dj = l1[blk[1:]]
            dinv[k, 1:sz] = np.where(dj != 0, 1.0 / np.where(
                dj == 0, 1.0, dj), 0.0)
            # the seed row restricted to the footprint (w[0] stays 0)
            lo, hi = indptr[s], indptr[s + 1]
            pos = {int(d): t for t, d in enumerate(blk)}
            for cc, vv in zip(indices[lo:hi], data[lo:hi]):
                t = pos.get(int(cc))
                if t is not None and t > 0:
                    w[k, t] = vv
            aseed[k] = diag[s] if diag[s] != 0 else 1.0
        ids_c.append(torch.as_tensor(ids).to(dev))
        di_c.append(torch.as_tensor(dinv, dtype=dtype).to(dev))
        w_c.append(torch.as_tensor(w, dtype=dtype).to(dev))
        sh_c.append(torch.as_tensor(aseed, dtype=dtype).to(dev))
        rc_c.append(torch.as_tensor(rcols).to(dev))
        rv_c.append(torch.as_tensor(rvals, dtype=dtype).to(dev))
    return Rank1SchurSmoother(ids_c, di_c, w_c, sh_c, rc_c, rv_c,
                              symmetric)
