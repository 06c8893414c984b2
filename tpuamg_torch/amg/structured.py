"""Structured (gather-free) hierarchy: slot orders, window levels, the
footprint operator and the host-tail hybrid, in torch ops and kernels.

Counterpart of the JAX package's ``amg/structured.py``.  Architecture
("pair + Morton windows"):

1. **Level 0 ordering (one host-side permutation).** Dofs are paired by
   heavy-edge matching on the strength graph (for the metric systems
   A + gamma*M the heaviest edges are the gamma-coupled partners), the
   pairs sorted by the Morton code of their centroid and laid out in slot
   groups of 2 (singletons ghost-padded).  ``order="hem"`` /
   ``"hem_banded[:W]"`` lays out a multilevel HEM tree instead
   (``hem_tree_slots``), ``"tiled"`` a tiled lattice for grid-bulk +
   curve systems (``lattice_tiled_slots``), ``"auto"`` the tiled order
   when the bulk is a clean lattice and Morton otherwise.

2. **Coarse levels = contiguous windows** of s=2 (level 0) then s=4
   consecutive slots: restriction is ``(r * mask).reshape(ng, s).sum(1)``,
   prolongation a broadcast (``StructuredLevel``).

3. **Operators are DIA** (``sparse.dia.DIA`` for float64 data and with
   ``pallas=False``, ``sparse.dia_kernels.KernelDIA`` for float32 data,
   whose matvec/residual are kernel K1 on the card, its wide entry above
   64 bands).  With interface dofs (3D-1D curve dofs) the wide coupling
   footprints move into batched dense blocks and a COO spill
   (``StructuredOp``, ``split_footprint_operator``): a gather, a batched
   ``bmm`` and an ``index_add_`` beside the narrow DIA, as the JAX
   package computes them with XLA ops outside any Pallas kernel.

4. **Smoothers**: slot-block Chebyshev (``BlockChebyshevSmoother``, B the
   slot-group block diagonal) composed with the footprint Schwarz of
   ``smoothers.schwarz`` (``FootprintMetricSmoother``) on levels with
   footprint blocks.  On window levels without them and with the kernel
   classes, the port's counterpart of the JAX package's VMEM-budget rule
   picks the smoother by K3's level table: ``FusedChebSmoother`` (kernel
   K3, one launch per application) when both A and C = B^{-1} have at
   most ``kernels.MAX_DIAGS`` bands, else ``DiaChebyshevSmoother`` with A
   and C as ``KernelDIA`` (each step a K1 residual, wide above 64 bands,
   and a K1 C apply).

The cycle driver is ``amg.hierarchy.MGPreconditioner``.  With
``algebraic_below`` the coarse levels come from the algebraic
``setup_amg`` in float64, either inside the same cycle or, with
``host_tail``, as a host-side float64 program between the two halves of
a split V-cycle (``HostTailHybrid``, driven by ``krylov.cg.pcg_split``;
the tail runs in ``native/tailkit.cpp`` where it covers the hierarchy).

``fp_solver="rank1g"`` (``DiagRank1Smoother``) is not ported (ROADMAP
Queue 1 item 13) and raises ValueError.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import kernels
from ..config import AMGParameters
from ..sparse.dia import DIA
from ..sparse.dia_kernels import (FusedChebSmoother, KernelDIA, _cheb_coefs,
                                  blockinv_dia)
from ..sparse.host import HostCSR, rap_unsmoothed
from .aggregation import hem_aggregation
from .strength import strength_graph


# ---------------------------------------------------------------------------
# smoothers, operator and level (device)
# ---------------------------------------------------------------------------

class BlockChebyshevSmoother:
    """Chebyshev polynomial smoother on B^{-1}A, B = slot-block diagonal.

    kind=1 classical / kind=4 fourth-kind (sparse.dia_kernels._cheb_coefs).
    """

    def __init__(self, blockinv, mask, lmax, lmin, degree=3, kind=1):
        self.blockinv = blockinv    # (n_groups, s, s)
        self.mask = mask            # (n_slots,) 1.0 real / 0.0 ghost
        self.lmax = lmax
        self.lmin = lmin
        self.degree = degree
        self.kind = kind

    def _binv(self, r):
        ng, s, _ = self.blockinv.shape
        rb = r.reshape(ng, s)
        bi = self.blockinv.to(r.dtype)
        return (torch.einsum("bij,bj->bi", bi, rb).reshape(-1)
                * self.mask.to(r.dtype))

    def smooth(self, A, x, b, iters=1, reverse=False):
        theta, coefs = _cheb_coefs(self.lmax, self.lmin, self.degree,
                                   self.kind)
        for _ in range(iters):
            r = self._binv(A.residual(x, b))
            d = r / theta
            for ak, ck in coefs:
                x = x + d
                r = self._binv(A.residual(x, b))
                d = ak * d + ck * r
            x = x + d
        return x


class DiaChebyshevSmoother:
    """Chebyshev on C*A where C (the masked block inverse B^{-1}) is itself
    a (2F-1)-diagonal operator (sparse.dia_kernels.blockinv_dia): each
    step is one residual and one C apply."""

    def __init__(self, C, lmax, lmin, degree=3, kind=1):
        self.C = C                  # DIA or KernelDIA, mask rows folded in
        self.lmax = lmax
        self.lmin = lmin
        self.degree = degree
        self.kind = kind

    def _binv(self, r):
        return self.C.matvec(r)

    smooth = BlockChebyshevSmoother.smooth


class StructuredOp:
    """Exact operator split  A = DIA + footprint-block correction.

    The 3D-1D coupling (cylinder average) gives each curve dof a wide 3D
    footprint; in slot space those entries scatter over O(1000) distinct
    diagonal offsets.  Every offset whose entries are all coverable by a
    footprint block moves into batched dense blocks (ids/mats): their
    application is one gather, a batched ``bmm`` and one ``index_add_``
    (through the ghost slot n of an n+1 buffer, which takes the padding)
    beside the narrow DIA matvec; entries at rare offsets beyond the band
    cap are a COO ``spill`` (one more gather and ``index_add_``).

    dia: DIA or KernelDIA; ids (nb, m) int64 padded with n; mats (nb, m,
    m); spill: None or (rows, cols, vals) tensors."""

    def __init__(self, dia, ids, mats, nnz=None, spill=None):
        self.dia = dia
        self.ids = ids
        self.mats = mats
        self.spill = spill
        self.shape = dia.shape
        self.nnz = nnz if nnz is not None else dia.nnz

    @property
    def dtype(self):
        return self.dia.dtype

    def _block_apply(self, x):
        xpad = torch.cat([x, x.new_zeros(1)])
        xb = xpad[self.ids]
        yb = torch.bmm(self.mats.to(x.dtype), xb.unsqueeze(-1)).squeeze(-1)
        y = torch.zeros_like(xpad).index_add_(
            0, self.ids.reshape(-1), yb.reshape(-1))[:-1]
        if self.spill is not None:
            r_, c_, v_ = self.spill
            y = y.index_add_(0, r_, v_.to(x.dtype) * x[c_])
        return y

    def matvec(self, x):
        return self.dia.matvec(x) + self._block_apply(x)

    def __matmul__(self, x):
        return self.matvec(x)

    def residual(self, x, b):
        return self.dia.residual(x, b) - self._block_apply(x)

    def diagonal(self):
        # offset 0 is always kept in the DIA part (split_footprint_operator)
        return self.dia.diagonal()


def _neighbor_blocks(A: HostCSR, seeds):
    """One block per seed: the seed + its full matrix-graph neighborhood
    (= the coupling footprint for 3D-1D curve dofs)."""
    indptr, indices = A.indptr, A.indices
    return [np.unique(np.concatenate(
        [[int(s)], indices[indptr[int(s)]:indptr[int(s) + 1]]]))
        for s in seeds]


def split_footprint_operator(A: HostCSR, blocks, max_offsets=None):
    """Exact split of A into (A_dia_host, ids, mats, spill).

    Every entry coverable by some block (both endpoints in it) is assigned
    to exactly one block; offsets whose entries are ALL coverable (except
    the main diagonal) move entirely to the block part, shrinking the DIA
    offset set from O(1000) to the bulk-stencil set.  Entries at offsets
    that also occur outside the blocks stay in the DIA part: the split is
    exact by construction (each entry lives in exactly one part).

    max_offsets: optional cap on the DIA band count — the most-populated
    offsets (main diagonal always) stay DIA, the tail moves to a COO
    ``spill`` (rows, cols, vals).  spill is None when nothing is capped.
    The entry lookup is vectorized (sorted-key searchsorted, per-offset
    coverage by bincount)."""
    n = A.shape[0]
    r, c, v = A.to_coo()
    keys = r.astype(np.int64) * n + c
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    covered = np.zeros(len(r), dtype=bool)
    assign = np.full(len(r), -1, dtype=np.int64)
    pos_i = np.zeros(len(r), dtype=np.int32)
    pos_j = np.zeros(len(r), dtype=np.int32)
    for bid, blk in enumerate(blocks):
        m = len(blk)
        kk = (blk[:, None].astype(np.int64) * n + blk[None, :]).ravel()
        loc = np.searchsorted(skeys, kk)
        locc = np.minimum(loc, len(skeys) - 1)
        hit = (loc < len(skeys)) & (skeys[locc] == kk)
        idx = order[locc[hit]]
        fresh = ~covered[idx]
        idxf = idx[fresh]
        covered[idxf] = True
        assign[idxf] = bid
        t = np.flatnonzero(hit)[fresh]
        pos_i[idxf] = (t // m).astype(np.int32)
        pos_j[idxf] = (t % m).astype(np.int32)
    offs = c - r
    uoff, oinv = np.unique(offs, return_inverse=True)
    tot = np.bincount(oinv)
    ncov = np.bincount(oinv, weights=covered).astype(np.int64)
    to_block = ((uoff != 0) & (ncov == tot))[oinv]
    keep = ~to_block
    spill = None
    if max_offsets is not None:
        cnt_keep = np.bincount(oinv[keep], minlength=len(uoff))
        sel = np.zeros(len(uoff), dtype=bool)
        sel[np.argsort(cnt_keep)[::-1][:max_offsets]] = True
        sel[uoff == 0] = True
        spill_sel = keep & ~sel[oinv]
        if spill_sel.any():
            spill = (r[spill_sel].astype(np.int64),
                     c[spill_sel].astype(np.int64), v[spill_sel])
            keep = keep & sel[oinv]
    A_dia = HostCSR.from_coo(r[keep], c[keep], v[keep], A.shape)
    nb = len(blocks)
    mpad = max((len(b) for b in blocks), default=1)
    ids = np.full((nb, mpad), n, dtype=np.int32)
    for bid, blk in enumerate(blocks):
        ids[bid, :len(blk)] = blk
    mats = np.zeros((nb, mpad, mpad))
    selb = np.flatnonzero(to_block)
    mats[assign[selb], pos_i[selb], pos_j[selb]] = v[selb]
    return A_dia, ids, mats, spill


class FootprintMetricSmoother:
    """Exact colored-multiplicative footprint Schwarz + slot-block
    Chebyshev, composed symmetrically: the structured-path counterpart of
    HAZmath's metric smoother split (interface Schwarz + GS elsewhere).
    Pre-smooth = Schwarz(sym) then Chebyshev; post-smooth (reverse) =
    Chebyshev then Schwarz(sym), so the cycle stays symmetric."""

    def __init__(self, schwarz, cheb):
        self.schwarz = schwarz
        self.cheb = cheb

    def smooth(self, A, x, b, iters=1, reverse=False):
        for _ in range(iters):
            if reverse:
                x = self.cheb.smooth(A, x, b, 1)
                x = self.schwarz.smooth(A, x, b, 1)
            else:
                x = self.schwarz.smooth(A, x, b, 1)
                x = self.cheb.smooth(A, x, b, 1)
        return x


class StructuredLevel:
    """Duck-typed MG level: DIA (or StructuredOp) operator + window-reshape
    transfers.  nc = the next level's (padded) row count; coarse groups
    beyond n_groups are pure ghosts (zero-pad / slice)."""

    def __init__(self, A, smoother, mask, s, n_groups, nc=None):
        self.A = A
        self.smoother = smoother
        self.mask = mask
        self.s = s
        self.n_groups = n_groups
        self.nc = n_groups if nc is None else nc

    def restrict(self, r):
        rc = (r * self.mask.to(r.dtype)).reshape(self.n_groups,
                                                 self.s).sum(dim=1)
        if self.nc > self.n_groups:
            rc = torch.cat([rc, rc.new_zeros(self.nc - self.n_groups)])
        return rc

    def prolong(self, ec):
        e = ec[:self.n_groups]
        ef = e[:, None].expand(self.n_groups, self.s).reshape(-1)
        return ef * self.mask.to(ec.dtype)


class HostTailHybrid:
    """Structured window levels on the device + the algebraic metric tail
    as a HOST-side float64 program.  Not an operator: krylov.cg.pcg_split
    drives it, running ``fine.cycle_down``, ``tail_apply`` and
    ``fine.cycle_up`` per PCG iteration.

    ``tail_apply`` takes and returns numpy float64.  The tail runs in the
    native executor (``native/tailkit.cpp``, ``native.tail.
    build_native_tail``) where that covers the hierarchy, else as torch
    ops on the CPU (``tail.matvec``; build_native_tail logs why).

    Mathematically the unified hybrid for cycle='v', maxit=1 (the tail
    recursion with a zero initial guess is tail.matvec)."""

    def __init__(self, fine, tail, A_boundary: HostCSR,
                 coarse_scaling=False):
        from ..native.tail import build_native_tail
        self.native = build_native_tail(tail)
        self.tail = tail                # MGPreconditioner on the CPU
        self.fine = fine
        self.coarse_scaling = coarse_scaling
        self._Ab = A_boundary           # boundary operator (host CSR)
        self.nc = A_boundary.shape[0]   # boundary vector length

    def tail_apply(self, rc_np):
        """ec = tail V-cycle applied to the boundary residual (host)."""
        rc64 = np.asarray(rc_np, dtype=np.float64)
        if self.native is not None:
            ec = self.native.apply(rc64)
        else:
            ec = self.tail.matvec(torch.from_numpy(rc64.copy())).numpy()
        if self.coarse_scaling and len(self.fine.levels) > 0:
            # the unified cycle scales the boundary correction with the
            # tail's level-0 operator only when the boundary lies between
            # two levels; it never scales its own top-level output, so
            # with no device levels the scaling is skipped
            Aec = self._Ab.matvec(ec)
            denom = float(ec @ Aec)
            alpha = min(max(float(rc64 @ ec) / denom, 0.0), 2.0) \
                if denom > 0 else 1.0
            ec = alpha * ec
        return ec


# ---------------------------------------------------------------------------
# host-side construction (copies)
# ---------------------------------------------------------------------------

def _grid_spacing(x):
    """Infer the native grid spacing of a coordinate array (median of
    positive diffs of the sorted unique values); 0 if degenerate."""
    u = np.unique(np.round(x, 12))
    if len(u) < 2:
        return 0.0
    d = np.diff(u)
    d = d[d > 1e-12]
    return float(np.median(d)) if len(d) else 0.0


def morton_code(coords, bits=16):
    """Z-order code per point (vectorized bit interleave), any dim <= 3.

    Coordinates are snapped to the data's own grid spacing per axis, so
    slot-distance offsets between mesh neighbors take few distinct
    values (what keeps the DIA operators narrow)."""
    crd = np.asarray(coords, dtype=np.float64)
    lo = crd.min(axis=0)
    d = crd.shape[1]
    q = np.zeros((len(crd), d), dtype=np.uint64)
    lim = np.uint64(2 ** bits - 1)
    for k in range(d):
        h = _grid_spacing(crd[:, k])
        if h <= 0:
            q[:, k] = 0
            continue
        qi = np.round((crd[:, k] - lo[k]) / h).astype(np.int64)
        q[:, k] = np.minimum(np.maximum(qi, 0), lim).astype(np.uint64)
    code = np.zeros(len(crd), dtype=np.uint64)
    for b in range(bits):
        for k in range(d):
            code |= ((q[:, k] >> np.uint64(b)) & np.uint64(1)) << \
                np.uint64(b * d + k)
    return code


def _hem_pairs(A: HostCSR, theta, group=None):
    """Level-0 pairing: HEM matching on the strength graph.  Returns
    match[i] = partner or -1.  group: optional per-row window id —
    matching edges are restricted to same-window pairs (banded HEM)."""
    S = strength_graph(A, theta)
    if group is not None:
        r, c, v = S.to_coo()
        keep = group[r] == group[c]
        S = HostCSR.from_coo(r[keep], c[keep], v[keep], S.shape)
    n = A.shape[0]
    # hem_aggregation is pure pairwise matching: groups of size 1 or 2
    agg, nagg = hem_aggregation(S)
    order = np.argsort(agg, kind="stable")
    sizes = np.bincount(agg, minlength=nagg)
    match = np.full(n, -1, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    two = np.flatnonzero(sizes == 2)
    a1 = order[starts[two]]
    a2 = order[starts[two] + 1]
    match[a1] = a2
    match[a2] = a1
    return match


def _pad_to_multiple(A: HostCSR, mask, mult):
    """Pad rows/cols to a multiple of mult with identity ghost rows."""
    n = A.shape[0]
    n2 = ((n + mult - 1) // mult) * mult
    if n2 == n:
        return A, mask
    r, c, v = A.to_coo()
    extra = np.arange(n, n2)
    A2 = HostCSR.from_coo(np.concatenate([r, extra]),
                          np.concatenate([c, extra]),
                          np.concatenate([v, np.ones(n2 - n)]), (n2, n2))
    return A2, np.concatenate([mask, np.zeros(n2 - n)])


def _window_coarse(A: HostCSR, mask, s):
    """Galerkin coarse operator for window aggregation agg[i] = i // s,
    restricted to real (mask=1) rows; ghost-only windows become identity
    coarse rows with mask 0."""
    n = A.shape[0]
    ng = n // s
    r, c, v = A.to_coo()
    real = (mask[r] > 0) & (mask[c] > 0)
    rc = r[real] // s
    cc = c[real] // s
    mask_c = (mask.reshape(ng, s).sum(axis=1) > 0).astype(np.float64)
    dead = np.flatnonzero(mask_c == 0)
    Ac = HostCSR.from_coo(
        np.concatenate([rc, dead]), np.concatenate([cc, dead]),
        np.concatenate([v[real], np.ones(len(dead))]), (ng, ng))
    return Ac, mask_c


def _slot_blocks(A: HostCSR, s):
    """Batched inverses of the (n_groups, s, s) slot-diagonal blocks."""
    n = A.shape[0]
    ng = n // s
    r, c, v = A.to_coo()
    inblk = (r // s) == (c // s)
    blocks = np.zeros((ng, s, s))
    blocks[r[inblk] // s, r[inblk] % s, c[inblk] % s] = v[inblk]
    # ensure invertibility where a slot has an empty diagonal
    idx = np.arange(s)
    diag = blocks[:, idx, idx]
    blocks[:, idx, idx] = np.where(diag == 0, 1.0, diag)
    return np.linalg.inv(blocks)


def _estimate_lmax(A: HostCSR, blockinv, mask, s, iters=15, seed=0):
    """Power-iteration bound of lambda_max(B^{-1} A) on the masked space,
    from the JAX package's seeded start vector."""
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    ng = blockinv.shape[0]
    x = rng.standard_normal(n) * mask
    lam = 1.0
    for _ in range(iters):
        y = A.matvec(x)
        y = np.einsum("bij,bj->bi", blockinv,
                      y.reshape(ng, s)).reshape(-1) * mask
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


def hem_tree_slots(A_host: HostCSR, coords, theta=0.1, max_rounds=30,
                   coarse_units=4, window=0):
    """Multilevel HEM matching tree -> slot permutation.

    Round 0 pairs dofs by HEM on strength(A); each later round pairs the
    previous round's units by HEM on the pair-Galerkin coarse operator,
    with leftover singletons force-paired by Morton adjacency of their
    centroids, so that the tree stays perfect (ghosts only from odd
    counts).  The slot order is the DFS leaf order: a round-k unit
    occupies 2^k consecutive slots, so the s=2 / s=4 windows of
    setup_structured ARE the HEM aggregates.  Top-level units are ordered
    by centroid Morton code.

    window > 0: banded HEM — each round's matching is restricted to pairs
    inside the same Morton macro-window of `window` units (narrower DIA
    bands, the metric couplings being spatially local).

    Returns (slots0, nsl): slots0[dof] = leaf slot; nsl = total leaves."""
    n0 = A_host.shape[0]
    crd = np.asarray(coords, dtype=np.float64)
    members = np.arange(n0, dtype=np.int64)[:, None]   # (nu, 2^k)
    cent = crd.copy()
    A = A_host
    rounds = 0
    while len(members) > coarse_units and rounds < max_rounds:
        group = None
        if window and len(members) > window:
            rank = np.empty(len(members), dtype=np.int64)
            rank[np.argsort(morton_code(cent), kind="stable")] = \
                np.arange(len(members))
            group = rank // int(window)
        match = _hem_pairs(A, theta * (0.5 ** rounds), group=group)
        left = np.flatnonzero(match < 0)
        if len(left) > 1:
            order = np.argsort(morton_code(cent[left]), kind="stable")
            lo = left[order]
            npair = len(lo) // 2
            a, b = lo[:2 * npair:2], lo[1:2 * npair:2]
            match[a] = b
            match[b] = a
        lead = (match < 0) | (np.arange(len(members)) < match)
        units = np.flatnonzero(lead)
        partner = match[units]
        w = members.shape[1]
        mem_new = np.full((len(units), 2 * w), -1, dtype=np.int64)
        mem_new[:, :w] = members[units]
        has_p = partner >= 0
        mem_new[has_p, w:] = members[partner[has_p]]
        cnt = (mem_new >= 0).sum(axis=1)
        csum = np.where((mem_new >= 0)[:, :, None],
                        crd[np.maximum(mem_new, 0)], 0.0).sum(axis=1)
        cent = csum / cnt[:, None]
        agg = np.empty(len(members), dtype=np.int64)
        agg[units] = np.arange(len(units))
        agg[partner[has_p]] = np.flatnonzero(has_p)
        A = rap_unsmoothed(A, agg, len(units))
        members = mem_new
        rounds += 1
    top = np.argsort(morton_code(cent), kind="stable")
    leaves = members[top].reshape(-1)
    nsl = len(leaves)
    slots0 = np.empty(n0, dtype=np.int64)
    real = leaves >= 0
    slots0[leaves[real]] = np.flatnonzero(real)
    return slots0, nsl


def lattice_tiled_slots(coords, idofs, n, tile=8, idof_stride=1):
    """Tiled-lattice slot ordering for grid-bulk + curve systems.

    The bulk dofs are snapped to their integer lattice, the lattice is
    padded to full `tile`^d tiles (ghost slots), tiles are ordered
    row-major and slots inside a tile by Morton code: every in-tile and
    cross-tile neighbor offset is then a constant, so the stencil takes
    O(stencil) distinct offsets at any size.  Interface dofs (idofs, the
    curve) get their own region after the bulk slots, ordered by Morton
    code of their coordinates.

    idof_stride > 1 reserves an aligned block of `idof_stride` slots per
    interface dof (the dof at the block start, ghosts after): with stride
    2*4^(L-1) an idof stays alone in its window through L window levels,
    i.e. it passes to every window coarse level by injection (see
    setup_structured(keep_idofs=...)).

    Returns (slots0, nsl); raises ValueError when the bulk dofs do not
    occupy a clean lattice (the caller falls back to 'morton')."""
    n_all = n
    idofs = np.asarray(idofs, dtype=np.int64) if idofs is not None \
        else np.empty(0, dtype=np.int64)
    bulk = np.setdiff1d(np.arange(n_all), idofs)
    crd = np.asarray(coords, dtype=np.float64)
    cb = crd[bulk]
    d = cb.shape[1]
    q = np.zeros((len(bulk), d), dtype=np.int64)
    for k in range(d):
        h = _grid_spacing(cb[:, k])
        if h <= 0:
            raise ValueError("degenerate bulk lattice axis")
        qi = np.round((cb[:, k] - cb[:, k].min()) / h)
        if np.max(np.abs(qi - np.round(qi))) > 1e-6:
            raise ValueError("bulk dofs off-lattice")
        q[:, k] = qi.astype(np.int64)
    dims = q.max(axis=0) + 1
    # occupancy check: unique cell per dof, full box
    flat = q[:, 0]
    for k in range(1, d):
        flat = flat * dims[k] + q[:, k]
    if len(np.unique(flat)) != len(bulk) or len(bulk) != int(
            np.prod(dims)):
        raise ValueError("bulk dofs are not a full lattice")
    ntile = -(-dims // tile)
    tid = q // tile
    tflat = tid[:, 0]
    for k in range(1, d):
        tflat = tflat * ntile[k] + tid[:, k]
    code_in = morton_code(q % tile, bits=4)
    slots_bulk = tflat * (tile ** d) + code_in.astype(np.int64)
    nbulk = int(np.prod(ntile)) * tile ** d
    # idof blocks start on idof_stride boundaries (window alignment)
    nbulk = -(-nbulk // idof_stride) * idof_stride
    slots0 = np.empty(n_all, dtype=np.int64)
    slots0[bulk] = slots_bulk
    if len(idofs):
        corder = np.argsort(morton_code(crd[idofs]), kind="stable")
        slots0[idofs[corder]] = nbulk + np.arange(len(idofs)) \
            * idof_stride
    nsl = nbulk + len(idofs) * idof_stride
    nsl = -(-nsl // 2) * 2
    return slots0, nsl


def _on(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(device)


def _dia_operator(A: HostCSR, dtype, kern, device):
    """K1's operator (KernelDIA) with the kernel classes, else the plain
    DIA."""
    if kern:
        return KernelDIA.from_host(A, dtype=dtype, device=device)
    return DIA.from_host(A, dtype=dtype, device=device)


def _structured_op(A_dia, op_ids, op_mats, spill, nnz, dtype, kern, dev):
    return StructuredOp(
        _dia_operator(A_dia, dtype, kern, dev),
        torch.as_tensor(op_ids.astype(np.int64)).to(dev),
        _on(op_mats, dtype, dev), nnz=nnz,
        spill=None if spill is None else (
            torch.as_tensor(spill[0]).to(dev),
            torch.as_tensor(spill[1]).to(dev),
            _on(spill[2], dtype, dev)))


def _window_smoother(A: HostCSR, blockinv, mask, lmax, cheb_ratio,
                     cheb_degree, cheb_kind, dtype, dev):
    """The kernel classes' smoother and operator of a window level without
    footprint blocks: (Adev, smoother).

    The JAX package picks FusedChebSmoother when the level fits a TPU VMEM
    budget (amg/structured.py:936-947).  The port's rule is K3's level
    table: FusedChebSmoother (K3, one launch per application) when A and
    C = B^{-1} both have at most kernels.MAX_DIAGS bands; otherwise
    DiaChebyshevSmoother with A and C as KernelDIA, each step one K1
    residual (its wide entry above MAX_DIAGS bands) and one K1 C apply."""
    coffs, cdata = blockinv_dia(blockinv, mask)
    Adev = KernelDIA.from_host(A, dtype=dtype, device=dev)
    C = KernelDIA(coffs, _on(cdata, dtype, dev), A.shape, 0)
    interval = (1.1 * lmax, 1.1 * lmax / cheb_ratio)
    if len(Adev.offsets) <= kernels.MAX_DIAGS and \
            len(coffs) <= kernels.MAX_DIAGS:
        sm = FusedChebSmoother.build(Adev, C, *interval, cheb_degree,
                                     kind=cheb_kind)
    else:
        sm = DiaChebyshevSmoother(C, *interval, cheb_degree,
                                  kind=cheb_kind)
    return Adev, sm


def setup_structured(A_host: HostCSR, coords,
                     params: AMGParameters = AMGParameters(),
                     dtype=torch.float32, cheb_degree=3, cheb_ratio=8.0,
                     cheb_kind=1, pairs=None, pallas=None, idofs=None,
                     order="morton", algebraic_below=0, fp_maxlvl=1,
                     fp_solver="exact", dia_max_offsets=1024,
                     host_tail=False, keep_idofs=0, device=None):
    """Build the gather-free structured hierarchy.

    coords: (n, d) spatial position per dof.  pairs: optional explicit
    partner map (match[i] = j or -1); default HEM matching on the strength
    graph.  idofs: interface dofs with wide coupling footprints (3D-1D
    curve dofs): with params.schwarz_levels > 0 (or keep_idofs) and
    0 < 8 len(idofs) < n (unless keep_idofs), the levels split their
    operator (StructuredOp) and level 0.. schwarz_levels-1 get footprint
    Schwarz blocks seeded at them (FootprintMetricSmoother):
    fp_solver "exact" (LocalSchwarzSmoother, with params.schwarz_cluster
    merging overlapping blocks) or "rank1" (Rank1SchurSmoother);
    "rank1g" is ROADMAP Queue 1 item 13 and raises.
    order: "morton", "hem", "hem_banded[:W]", "tiled" or "auto" (module
    docstring).
    algebraic_below: real-dof threshold below which the remaining levels
    are the algebraic float64 setup_amg tail (0 = a pure window
    hierarchy with a dense coarse inverse); host_tail: that tail as a
    host program (HostTailHybrid; cycle 'v', maxit 1 only).
    keep_idofs: L > 0 keeps every interface dof uncoarsened (injected)
    through at most L window levels; needs the tiled order.
    pallas: None / True / False, the grid path's rule
    (amg.grid.use_kernels): the kernel classes (KernelDIA -> K1,
    FusedChebSmoother -> K3) for float32 data, the plain classes for
    float64 data and with pallas=False.
    device: None = the CUDA card; "cpu" runs the plain versions.  A host
    tail always lives on the CPU.

    Returns (prec, slots0, n_slots0): solve in slot space — b scattered
    to slots0, x gathered back (problems.solve.solve_system)."""
    from .grid import use_kernels
    from .hierarchy import MGPreconditioner, setup_amg
    from ..smoothers.schwarz import build_local_schwarz, build_rank1_schur
    if fp_solver not in ("exact", "rank1"):
        raise ValueError(
            f"fp_solver={fp_solver!r}: the port builds 'exact' and 'rank1' "
            f"footprint smoothers; 'rank1g' (DiagRank1Smoother) is not "
            f"ported (ROADMAP Queue 1 item 13)")
    dev = kernels.resolve_device(device)
    kern = use_kernels(pallas, dtype)
    n0 = A_host.shape[0]
    crd = np.asarray(coords, dtype=np.float64)
    keep_idofs = int(keep_idofs or 0)
    if keep_idofs and (idofs is None or not len(idofs)):
        keep_idofs = 0
    stride = 2 * 4 ** (keep_idofs - 1) if keep_idofs else 1
    if order in ("tiled", "auto") and pairs is None:
        try:
            slots0, nsl = lattice_tiled_slots(crd, idofs, n0,
                                              idof_stride=stride)
        except ValueError:
            if order == "tiled":
                raise
            order = "morton"
        else:
            order = "_tiled_done"
    if keep_idofs and order != "_tiled_done":
        raise ValueError(
            "keep_idofs requires the tiled slot order (aligned idof "
            f"stride blocks); order={order!r} does not support it")
    if order == "_tiled_done":
        pass
    elif order is not None and order.startswith("hem") and pairs is None:
        window = 0
        if order.startswith("hem_banded"):
            window = int(order.split(":", 1)[1]) if ":" in order else 64
        slots0, nsl = hem_tree_slots(A_host, crd, params.strong_coupled,
                                     window=window)
    else:
        match = pairs if pairs is not None else _hem_pairs(
            A_host, params.strong_coupled)
        # units (pairs + singletons), sorted by Morton of their centroid
        lead = (match < 0) | (np.arange(n0) < match)
        units = np.flatnonzero(lead)
        cent = crd[units].copy()
        has_p = match[units] >= 0
        cent[has_p] = 0.5 * (crd[units[has_p]] + crd[match[units[has_p]]])
        uorder = np.argsort(morton_code(cent), kind="stable")
        units = units[uorder]
        # slot layout: unit u -> slots (2u, 2u+1)
        slots0 = np.empty(n0, dtype=np.int64)
        slots0[units] = 2 * np.arange(len(units))
        partner = match[units]
        paired = partner >= 0
        slots0[partner[paired]] = 2 * np.flatnonzero(paired) + 1
        nsl = 2 * len(units)
    mask = np.zeros(nsl)
    mask[slots0] = 1.0

    r, c, v = A_host.to_coo()
    ghost = np.flatnonzero(mask == 0)
    A = HostCSR.from_coo(
        np.concatenate([slots0[r], ghost]),
        np.concatenate([slots0[c], ghost]),
        np.concatenate([v, np.ones(len(ghost))]), (nsl, nsl))

    # Footprint blocks only for genuinely low-dimensional interfaces (3D-1D
    # curve dofs: n1 << n); keep_idofs forces them on (the production
    # regime where the curve can be denser than the gate allows).
    fp_blocks = fp_seeds = None
    if (idofs is not None
            and (params.schwarz_levels > 0 or keep_idofs)
            and (keep_idofs or 0 < len(idofs) * 8 < A_host.shape[0])):
        fp_seeds = np.sort(slots0[np.asarray(idofs)])
        fp_blocks = _neighbor_blocks(A, fp_seeds)
    levels = []
    # interface slots through window coarsening, for the tail's idofs
    tail_seeds = np.sort(slots0[np.asarray(idofs)]) \
        if idofs is not None and len(idofs) else None
    s = 2
    while (len(levels) < params.max_levels - 1
           and (not keep_idofs or len(levels) < keep_idofs)
           and mask.sum() > max(params.coarse_dof, algebraic_below)):
        A, mask = _pad_to_multiple(A, mask, s)
        ng = A.shape[0] // s
        blockinv = _slot_blocks(A, s)
        fp_schwarz = None
        if fp_blocks is not None and len(levels) < params.schwarz_levels:
            # exact colored-multiplicative Schwarz on footprint blocks with
            # local per-color residuals (FootprintMetricSmoother)
            mm = max(params.schwarz_mmsize,
                     max(len(b) for b in fp_blocks) + 1)
            if fp_solver == "exact":
                fp_schwarz = build_local_schwarz(
                    A, seeds=fp_seeds, maxlvl=fp_maxlvl, mmsize=mm,
                    symmetric=True, dtype=dtype,
                    cluster=params.schwarz_cluster, device=dev)
            else:
                fp_schwarz = build_rank1_schur(
                    A, seeds=fp_seeds, maxlvl=fp_maxlvl, mmsize=mm,
                    symmetric=True, dtype=dtype, device=dev)
        lmax = _estimate_lmax(A, blockinv, mask, s)
        if fp_blocks is not None:
            # exact DIA + footprint-block split (O(1000) offsets would
            # otherwise land in the DIA)
            A_dia, op_ids, op_mats, spill = split_footprint_operator(
                A, fp_blocks, max_offsets=dia_max_offsets)
            Adev = _structured_op(A_dia, op_ids, op_mats, spill, A.nnz,
                                  dtype, kern, dev)
            smoother = BlockChebyshevSmoother(
                _on(blockinv, dtype, dev), _on(mask, dtype, dev),
                1.1 * lmax, 1.1 * lmax / cheb_ratio, cheb_degree,
                kind=cheb_kind)
            if fp_schwarz is not None:
                smoother = FootprintMetricSmoother(fp_schwarz, smoother)
        elif kern:
            Adev, smoother = _window_smoother(
                A, blockinv, mask, lmax, cheb_ratio, cheb_degree,
                cheb_kind, dtype, dev)
        else:
            smoother = BlockChebyshevSmoother(
                _on(blockinv, dtype, dev), _on(mask, dtype, dev),
                1.1 * lmax, 1.1 * lmax / cheb_ratio, cheb_degree,
                kind=cheb_kind)
            Adev = DIA.from_host(A, dtype=dtype, device=dev)
        levels.append(StructuredLevel(Adev, smoother, _on(mask, dtype, dev),
                                      s, ng))
        A, mask = _window_coarse(A, mask, s)
        if tail_seeds is not None:
            tail_seeds = np.unique(tail_seeds // s)
        if fp_blocks is not None:
            fp_blocks = [np.unique(blk // s) for blk in fp_blocks]
            fp_seeds = np.unique(fp_seeds // s)
        s = 4

    # level nc = the next level's (padded) row count; the coarsest
    # structured level's nc = the dense-coarse (or tail) size
    for i, L in enumerate(levels):
        L.nc = levels[i + 1].A.shape[0] if i + 1 < len(levels) \
            else A.shape[0]
    n_slots0 = levels[0].A.shape[0] if levels else A.shape[0]
    cyc = dict(presmooth=params.presmooth_iter,
               postsmooth=params.postsmooth_iter,
               amli_degree=params.amli_degree, max_w_work=params.max_w_work,
               coarse_scaling=params.coarse_scaling)
    if algebraic_below and mask.sum() > params.coarse_dof:
        # the algebraic metric-AMG tail, always float64 (the metric tail
        # is f32-fragile, the window levels are not); it gets the
        # interface dofs (Schwarz on them, GS elsewhere): fp_seeds carry
        # them through window coarsening, tail_seeds when the footprint
        # gate is off
        tail_idofs = fp_seeds if fp_blocks is not None else tail_seeds
        tprm = replace(params, dtype="float64")
        if host_tail:
            if params.cycle_type != "v" or params.maxit != 1:
                raise ValueError("host_tail supports cycle_type='v', "
                                 "maxit=1 (the .dat metric config)")
            tail = setup_amg(A, tprm, idofs=tail_idofs, device="cpu")
            fine = MGPreconditioner(tuple(levels), None, cycle="v",
                                    maxit=1, **cyc)
            prec = HostTailHybrid(fine, tail, A,
                                  coarse_scaling=params.coarse_scaling)
            return prec, slots0, n_slots0
        tail = setup_amg(A, tprm, idofs=tail_idofs, device=dev)
        prec = MGPreconditioner(
            tuple(levels) + tuple(tail.levels), tail.coarse_inv,
            cycle=params.cycle_type, maxit=params.maxit, **cyc)
        return prec, slots0, n_slots0
    coarse_inv = np.linalg.inv(A.toarray()) if A.shape[0] else \
        np.zeros((0, 0))
    prec = MGPreconditioner(
        tuple(levels), _on(coarse_inv, dtype, dev),
        cycle=params.cycle_type, maxit=params.maxit, **cyc)
    return prec, slots0, n_slots0


def structured_system(A_host: HostCSR, slots, n_slots, dtype=torch.float32,
                      pallas=None, idofs=None, dia_max_offsets=1024,
                      device=None):
    """The outer operator permuted into slot space (identity ghosts).

    idofs: as in setup_structured — with wide coupling footprints (3D-1D)
    the operator is a narrow DIA plus batched footprint blocks
    (StructuredOp).  The DIA is a KernelDIA (K1) for float32 data and the
    plain DIA for float64 data or with pallas=False."""
    from .grid import use_kernels
    dev = kernels.resolve_device(device)
    kern = use_kernels(pallas, dtype)
    r, c, v = A_host.to_coo()
    mask = np.zeros(n_slots)
    mask[slots] = 1.0
    ghost = np.flatnonzero(mask == 0)
    A_slots = HostCSR.from_coo(
        np.concatenate([slots[r], ghost]),
        np.concatenate([slots[c], ghost]),
        np.concatenate([v, np.ones(len(ghost))]), (n_slots, n_slots))
    if (idofs is not None
            and 0 < len(idofs) * 8 < A_host.shape[0]):
        blocks = _neighbor_blocks(A_slots,
                                  np.sort(slots[np.asarray(idofs)]))
        A_dia, op_ids, op_mats, spill = split_footprint_operator(
            A_slots, blocks, max_offsets=dia_max_offsets)
        return _structured_op(A_dia, op_ids, op_mats, spill, A_slots.nnz,
                              dtype, kern, dev)
    return _dia_operator(A_slots, dtype, kern, dev)
