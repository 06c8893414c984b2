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
``LocalSchwarzSmoother``, ``Rank1SchurSmoother`` and ``DiagRank1Smoother``
belong to the 3D-1D paths (ROADMAP Queue 1 items 10 and 13).
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
