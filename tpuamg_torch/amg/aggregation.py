"""Aggregation algorithms: VMB and HEM (+ MIS via VMB pass structure).

Copy of the JAX package's ``amg/aggregation.py``: HAZmath's aggregation
menu (``aggregation_type`` VMB/MIS/MWM/HEC/HEM, reference
amg_parameters.py:16,59):

- VMB (Vanek-Mandel-Brezina): the classic 3-pass greedy standard
  aggregation used by the ``hazmath`` / ``hazmath_Schwarz`` preconditioners.
- HEM (heavy-edge matching): pairwise aggregation by strongest edge — the
  aggregation of the *metric* AMG presets (``parameters_metric``,
  reference amg_parameters.py:59). Implemented as vectorized
  hand-shaking matching (each node proposes to its heaviest unmatched strong
  neighbor; mutual proposals match), iterated a few rounds — the standard
  parallel formulation, numpy-vectorized on host.

Returns agg: int64 array, agg[i] = aggregate id (>= 0 for all i — isolated
nodes become singletons), and the aggregate count.
"""
from __future__ import annotations

import os

import numpy as np

from ..sparse.host import HostCSR


def _compress_ids(agg):
    used, inv = np.unique(agg[agg >= 0], return_inverse=True)
    out = np.full(len(agg), -1, dtype=np.int64)
    out[agg >= 0] = inv
    return out, len(used)


def vmb_aggregation(S: HostCSR, max_aggregation=100):
    """Vanek-Mandel-Brezina standard aggregation on strength graph S.
    Dispatches to the native C++ kernel when available."""
    if not os.environ.get("TPUAMG_NO_NATIVE"):
        from ..native import native_vmb
        out = native_vmb(S, max_aggregation)
        if out is not None:
            return _compress_ids(out[0])
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, dtype=np.int64)
    # pass 1: seed aggregates around nodes whose strong neighborhood is
    # entirely unaggregated
    nagg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbr = indices[indptr[i]:indptr[i + 1]]
        if np.all(agg[nbr] < 0):
            agg[i] = nagg
            take = nbr[:max_aggregation - 1]
            agg[take] = nagg
            nagg += 1
    # pass 2: attach remaining nodes to a neighboring aggregate
    unagg = np.flatnonzero(agg < 0)
    for i in unagg:
        nbr = indices[indptr[i]:indptr[i + 1]]
        cand = agg[nbr]
        cand = cand[cand >= 0]
        if len(cand):
            agg[i] = cand[0]
    # pass 3: new aggregates from what's left (isolated/weak nodes)
    for i in np.flatnonzero(agg < 0):
        if agg[i] >= 0:
            continue
        agg[i] = nagg
        nbr = indices[indptr[i]:indptr[i + 1]]
        free = nbr[agg[nbr] < 0]
        agg[free[:max_aggregation - 1]] = nagg
        nagg += 1
    return _compress_ids(agg)


def hem_aggregation(S: HostCSR, rounds=8):
    """Heavy-edge matching via vectorized hand-shaking.

    Each unmatched node points at its heaviest unmatched strong neighbor;
    mutual pairs merge (= locally-heaviest-edge matching).  Ties are broken
    by a *symmetric* pseudo-random edge key — without it, equal-weight
    graphs (constant-coefficient Laplacians) produce no mutual proposals at
    all.  A constant fraction of free nodes matches per round; leftovers
    after `rounds` become singletons (HAZmath HEM keeps leftovers too)."""
    n = S.shape[0]
    match = np.full(n, -1, dtype=np.int64)   # partner id (or self)
    indices = S.indices.astype(np.int64)
    data = S.data
    rows = S.rows_expanded()
    # symmetric per-undirected-edge tie-break key
    lo = np.minimum(rows, indices)
    hi = np.maximum(rows, indices)
    tie = ((lo * np.int64(2654435761) + hi * np.int64(40503))
           % np.int64(2 ** 31)).astype(np.float64)
    for _ in range(rounds):
        free = match < 0
        if not free.any():
            break
        # candidate edges: both endpoints free
        ok = free[rows] & free[indices]
        if not ok.any():
            break
        r, c, w, t = rows[ok], indices[ok], data[ok], tie[ok]
        # heaviest neighbor per row: sort by (row, weight, tiebreak), last
        order = np.lexsort((t, w, r))
        rr, cc = r[order], c[order]
        last = np.flatnonzero(np.r_[rr[1:] != rr[:-1], True])
        choice = np.full(n, -1, dtype=np.int64)
        choice[rr[last]] = cc[last]
        hit = np.flatnonzero(choice >= 0)
        mutual = hit[(choice[choice[hit]] == hit) & (hit < choice[hit])]
        match[mutual] = choice[mutual]
        match[choice[mutual]] = mutual
    # aggregates: pairs + singletons
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0
    lead = (match < 0) | (np.arange(n) < match)
    ids = np.flatnonzero(lead)
    agg[ids] = np.arange(len(ids))
    partner = match[ids]
    has_partner = partner >= 0
    agg[partner[has_partner]] = agg[ids[has_partner]]
    return _compress_ids(agg)


def mis_aggregation(S: HostCSR, max_aggregation=100):
    """Maximal-independent-set seeded aggregation (the MIS option):
    distance-2 MIS seeds, then attach every node to its strongest seed."""
    n = S.shape[0]
    indptr, indices, data = S.indptr, S.indices.astype(np.int64), S.data
    state = np.zeros(n, dtype=np.int8)   # 0 undecided, 1 seed, 2 covered
    for i in range(n):
        if state[i] == 0:
            state[i] = 1
            state[indices[indptr[i]:indptr[i + 1]]] = np.where(
                state[indices[indptr[i]:indptr[i + 1]]] == 0, 2,
                state[indices[indptr[i]:indptr[i + 1]]])
    seeds = np.flatnonzero(state == 1)
    agg = np.full(n, -1, dtype=np.int64)
    agg[seeds] = np.arange(len(seeds))
    # attach covered nodes to strongest neighboring seed
    rows = S.rows_expanded()
    is_seed_col = agg[indices] >= 0
    r, c, w = rows[is_seed_col], indices[is_seed_col], data[is_seed_col]
    order = np.lexsort((w, r))
    rr, cc = r[order], c[order]
    last = np.flatnonzero(np.r_[rr[1:] != rr[:-1], True])
    agg[rr[last]] = np.where(agg[rr[last]] < 0, agg[cc[last]], agg[rr[last]])
    # leftovers become singletons
    left = np.flatnonzero(agg < 0)
    agg[left] = np.arange(len(seeds), len(seeds) + len(left))
    return _compress_ids(agg)


def mwm_aggregation(S: HostCSR, max_aggregation=100, rounds=64):
    """Greedy maximum-weight matching (the MWM option, reference
    amg_parameters.py:16 enum menu).

    Sequential greedy-by-weight matching is equivalent to repeatedly taking
    all *locally dominant* edges (heaviest at both endpoints) when edge
    weights carry a strict total order — so this is the HEM hand-shake
    iterated to convergence with a deterministic tie order, which yields the
    classic 1/2-approximation of the maximum-weight matching rather than
    HEM's fixed-round heuristic subset."""
    return hem_aggregation(S, rounds=rounds)


def hec_aggregation(S: HostCSR, max_aggregation=100):
    """Heavy-edge coarsening (the HEC option): every node joins the cluster
    of its heaviest strong neighbor (clusters may exceed pairs).

    Vectorized as the connected components of the heaviest-neighbor pointer
    graph.  With a strict total edge order the only cycles in that
    functional graph are mutual 2-cycles (following pointers, edge weights
    strictly increase otherwise), so components resolve by breaking
    2-cycles to the smaller index and pointer-doubling.  Oversized
    components are split in pointer-chase order to respect
    ``max_aggregation``."""
    n = S.shape[0]
    indices = S.indices.astype(np.int64)
    data = S.data
    rows = S.rows_expanded()
    if len(rows) == 0:
        return _compress_ids(np.arange(n, dtype=np.int64))
    # strict total order on edges: weight, then symmetric pseudo-random key
    lo = np.minimum(rows, indices)
    hi = np.maximum(rows, indices)
    tie = ((lo * np.int64(2654435761) + hi * np.int64(40503))
           % np.int64(2 ** 31)).astype(np.float64)
    order = np.lexsort((tie, data, rows))
    rr, cc = rows[order], indices[order]
    last = np.flatnonzero(np.r_[rr[1:] != rr[:-1], True])
    parent = np.arange(n, dtype=np.int64)       # isolated nodes: singletons
    parent[rr[last]] = cc[last]
    # break mutual 2-cycles to the smaller index as the root
    mutual = parent[parent] == np.arange(n)
    root2 = mutual & (np.arange(n) < parent)
    parent[np.flatnonzero(root2)] = np.flatnonzero(root2)
    # pointer doubling to the component root
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
        parent = parent[parent]
    if np.any(parent[parent] != parent):   # tie-key collision made a >2 cycle
        root = np.arange(n, dtype=np.int64)

        def find(i):
            while root[i] != i:
                root[i] = root[root[i]]
                i = root[i]
            return i
        for i, j in zip(rr[last], cc[last]):
            ri, rj = find(i), find(j)
            if ri != rj:
                root[max(ri, rj)] = min(ri, rj)
        parent = np.array([find(i) for i in range(n)], dtype=np.int64)
    agg, _ = _compress_ids(parent)
    # split components above max_aggregation (HAZmath caps aggregate size)
    if max_aggregation and max_aggregation > 0:
        orderc = np.argsort(agg, kind="stable")
        sortedagg = agg[orderc]
        newblock = np.r_[True, sortedagg[1:] != sortedagg[:-1]]
        pos = np.arange(n) - np.maximum.accumulate(
            np.where(newblock, np.arange(n), 0))
        sub = pos // max_aggregation
        split = np.empty(n, dtype=np.int64)
        split[orderc] = sortedagg * (pos.max() // max_aggregation + 1) + sub
        agg = split
    return _compress_ids(agg)


AGGREGATORS = {"vmb": vmb_aggregation, "hem": hem_aggregation,
               "mis": mis_aggregation, "mwm": mwm_aggregation,
               "hec": hec_aggregation}
