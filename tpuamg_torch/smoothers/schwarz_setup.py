"""Vectorized Schwarz-block setup (host graph work, dense block inverses).

Copy of the JAX package's ``smoothers/schwarz_setup.py``; sparse pattern
algebra in place of per-seed Python BFS:
- seed selection: greedy-by-order MIS on the pattern of A^maxlvl restricted
  to the interface dofs — maximal independent => dominating, so every idof
  lands in some block (coverage), while block count stays ~n/deg;
- blocks: the maxlvl-balls around the seeds (row-sliced |A| products),
  capped at mmsize by descending path weight;
- coloring: greedy on the block-overlap graph, so that blocks of one color
  share no dof;
- block matrices: batched dense extraction through ELL-membership einsums,
  batched inversion with numpy — the role of HAZmath's per-block UMFPACK
  factorizations (Schwarz_blksolver=32, reference amg_parameters.py:43).
The inverses go to the device in the smoother's dtype.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..kernels import resolve_device
from ..sparse.host import HostCSR


def _pattern(A: HostCSR) -> HostCSR:
    return HostCSR(A.indptr, A.indices, np.ones(A.nnz), A.shape)


def pattern_power(A: HostCSR, k: int) -> HostCSR:
    """Boolean pattern of (A + I)^k (k-hop reachability)."""
    n = A.shape[0]
    G = _pattern(A).add(HostCSR.eye(n))
    G = HostCSR(G.indptr, G.indices, np.ones(G.nnz), G.shape)
    out = G
    for _ in range(k - 1):
        out = out.matmat(G)
        out = HostCSR(out.indptr, out.indices, np.ones(out.nnz), out.shape)
    return out


def greedy_mis(G: HostCSR, candidates) -> np.ndarray:
    """Greedy maximal independent set of G restricted to `candidates`
    (single ordered pass; dominating within the candidate set).
    Dispatches to the native C++ kernel when available."""
    if not os.environ.get("TPUAMG_NO_NATIVE"):
        from ..native import native_mis
        out = native_mis(G, candidates)
        if out is not None:
            return out
    n = G.shape[0]
    cand = np.zeros(n, dtype=bool)
    cand[np.asarray(candidates)] = True
    state = np.zeros(n, dtype=np.int8)  # 0 free, 1 seed, 2 blocked
    indptr, indices = G.indptr, G.indices
    seeds = []
    for i in np.asarray(candidates):
        if state[i] != 0:
            continue
        state[i] = 1
        seeds.append(i)
        nbr = indices[indptr[i]:indptr[i + 1]]
        sel = nbr[(state[nbr] == 0)]
        state[sel] = 2
    return np.asarray(seeds, dtype=np.int64)


def balls_at_seeds(Gk: HostCSR, seeds, mmsize) -> np.ndarray:
    """Padded (nb, m) dof ids of the k-balls at the seeds; pad = n."""
    n = Gk.shape[0]
    lens = (Gk.indptr[seeds + 1] - Gk.indptr[seeds]).astype(np.int64)
    m = int(min(lens.max(), mmsize))
    ids = np.full((len(seeds), m), n, dtype=np.int32)
    for k, s in enumerate(seeds):        # slice copy; cheap relative to BFS
        row = Gk.indices[Gk.indptr[s]:Gk.indptr[s + 1]][:m]
        ids[k, :len(row)] = np.sort(row)
    return ids


def color_seed_blocks(G2k: HostCSR, seeds) -> np.ndarray:
    """Greedy coloring of seeds under the overlap graph G^(2k)."""
    n = G2k.shape[0]
    seed_rank = np.full(n, -1, dtype=np.int64)
    seed_rank[seeds] = np.arange(len(seeds))
    colors = np.full(len(seeds), -1, dtype=np.int32)
    indptr, indices = G2k.indptr, G2k.indices
    for k, s in enumerate(seeds):
        nbr = indices[indptr[s]:indptr[s + 1]]
        nbr_ranks = seed_rank[nbr]
        used = set(colors[r] for r in nbr_ranks[nbr_ranks >= 0]
                   if colors[r] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[k] = c
    return colors


def _extract_dense_blocks(cols_np, vals_np, ids, n, chunk=8192):
    """dense[b, p, q] = A[ids[b,p], ids[b,q]] via membership einsum over
    the ELL planes (host numpy, chunked). ids pad value = n (ghost): ghost
    rows/cols become zero with 1 on the diagonal, so batched inversion is
    well-posed."""
    nb, m = ids.shape
    out = np.empty((nb, m, m), dtype=vals_np.dtype)
    eye = np.eye(m, dtype=vals_np.dtype)
    for lo in range(0, nb, chunk):
        idb = ids[lo:lo + chunk]
        safe = np.minimum(idb, n - 1)
        cols = cols_np[safe]                         # (c, m, L)
        vals = vals_np[safe]
        is_real = idb < n
        hit = (cols[:, :, :, None] == idb[:, None, None, :])
        dense = np.einsum("bplq,bpl->bpq", hit.astype(vals.dtype), vals)
        mask = is_real[:, :, None] & is_real[:, None, :]
        dense = np.where(mask, dense, 0.0) \
            + np.where(is_real, 0.0, 1.0)[:, :, None] * eye[None]
        out[lo:lo + chunk] = dense
    return out


def seed_balls(A: HostCSR, seeds, maxlvl, mmsize):
    """Padded (nb, m) dof ids of the maxlvl-balls at the seeds, computed
    via ROW-SLICED |A|-products (never forms the full A^k pattern —
    systems with near-dense rows, e.g. cylinder-average coupling, would
    explode it). Pad value = n.

    When a ball exceeds mmsize, members are kept by DESCENDING path weight
    (|A| product magnitude), so the cap drops the weakest couplings —
    truncating arbitrary members silently drops gamma-stiff couplings and
    destroys robustness at extreme gamma (measured: 300 stalled iterations
    vs 6 on the 3D-1D system at gamma=1e8)."""
    from .relaxation import slice_rows
    n = A.shape[0]
    Gabs = HostCSR(A.indptr, A.indices, np.abs(A.data), A.shape).add(
        HostCSR.eye(n))
    B = slice_rows(Gabs, seeds)
    for _ in range(maxlvl - 1):
        B = B.matmat(Gabs)
    lens = (B.indptr[1:] - B.indptr[:-1]).astype(np.int64)
    m = int(min(lens.max(), mmsize))
    ids = np.full((len(seeds), m), n, dtype=np.int32)
    for k in range(len(seeds)):
        sl = slice(B.indptr[k], B.indptr[k + 1])
        row = B.indices[sl]
        if len(row) > m:
            keep = np.argsort(-B.data[sl])[:m]
            row = row[keep]
        ids[k, :len(row)] = np.sort(row)
    return ids


def merge_overlapping_blocks(blocks, cap):
    """Merge runs of consecutive overlapping blocks, capped at `cap`.

    At production 3D-1D curve resolutions, MANY curve dofs share each
    bulk cell (segment length << h: ~40 per cell at the n=64 reference
    case), so per-seed footprint blocks coincide almost entirely and
    overlap ~(curve dofs per cell) deep.  A colored multiplicative
    sweep over such blocks revisits the same gamma-chain dozens of
    times with stale residuals (the Local variant) or needs dozens of
    colors (the global variant), and the mmsize cap truncates exactly
    the shared couplings — the measured h-GROWTH of the 3D-1D solves
    (scripts/exp_3d1d_hrobust.py: 6->11->18 iters over n=8/16/32).
    Merging each run of mutually-overlapping consecutive blocks (seed
    order = curve order) yields few, shallowly-overlapping blocks that
    contain each gamma-chain wholly; the dense block solve then treats
    the chain exactly."""
    out, cur = [], None
    for blk in blocks:
        blk = np.asarray(blk)
        if cur is not None:
            u = np.union1d(cur, blk)
            if len(u) <= cap and len(u) < len(cur) + len(blk):
                cur = u
                continue
            out.append(cur)
        cur = blk
    if cur is not None:
        out.append(cur)
    return out


def _pad_blocks(blocks, n):
    m = max((len(b) for b in blocks), default=1)
    ids = np.full((len(blocks), m), n, dtype=np.int32)
    for i, b in enumerate(blocks):
        ids[i, :len(b)] = b
    return ids


def _color_by_overlap(ids, n):
    """Greedy coloring of blocks sharing any dof (padded id matrix): in
    block order, each block takes the smallest color that no earlier
    block sharing a dof with it has.  The pairs come from the block-dof
    incidence product, each pair once: walking every shared dof instead
    repeats a pair once per dof the two blocks share, which at deep
    overlap (clustered 3D-1D interface blocks, hundreds of shared dofs)
    costs minutes of host time for the same colors."""
    nb, m = ids.shape
    flat = ids.reshape(-1).astype(np.int64)
    keep = flat < n
    inc = HostCSR.from_coo(np.repeat(np.arange(nb), m)[keep], flat[keep],
                           np.ones(int(keep.sum())), (nb, n))
    adj = inc.matmat(inc.T)
    colors = np.full(nb, -1, dtype=np.int32)
    for bi in range(nb):
        used = colors[adj.indices[adj.indptr[bi]:adj.indptr[bi + 1]]]
        used = used[used >= 0]
        taken = np.zeros(len(used) + 1, dtype=bool)
        taken[used[used <= len(used)]] = True
        colors[bi] = int(np.argmin(taken))
    return colors


def build_schwarz_fast(A_host: HostCSR, idofs, maxlvl=1, mmsize=100,
                       symmetric=True, weight=1.0, dtype=torch.float32,
                       cluster=False, device=None):
    """Vectorized construction of a colored overlapping Schwarz smoother.

    cluster=True merges runs of overlapping seed balls into shared
    blocks (merge_overlapping_blocks) — the cure for deeply-overlapping
    interface footprints (curve dofs denser than the bulk mesh).

    Returns a SchwarzSmoother (see .schwarz) with per-color padded id and
    inverse-block tensors.
    """
    from .schwarz import SchwarzSmoother
    dev = resolve_device(device)
    n = A_host.shape[0]
    idofs = np.asarray(idofs, dtype=np.int64)
    # HAZmath seeds a block at *every* interface dof; MIS-thinning is our
    # block-count control for large interface sets. For small ones (e.g.
    # the 3D-1D curve dofs) thinning loses exactly the blocks that must
    # capture each dof's stiff coupling footprint — seed them all.
    if len(idofs) <= 8192 or cluster:
        seeds = idofs
    else:
        seeds = greedy_mis(pattern_power(A_host, maxlvl), idofs)
    ids = seed_balls(A_host, seeds, maxlvl, mmsize)
    if cluster:
        ids = _pad_blocks(
            merge_overlapping_blocks([row[row < n] for row in ids],
                                     mmsize), n)
    colors = _color_by_overlap(ids, n)

    nb, m = ids.shape
    lens = A_host.row_lengths()
    L = int(lens.max()) if len(lens) else 1
    if nb * m * L * m * 8 <= 2 ** 31:   # einsum memory budget (~2 GB)
        cols_np = np.full((n, L), n, dtype=np.int64)
        vals_np = np.zeros((n, L), dtype=np.float64)
        slot = np.arange(A_host.nnz) - np.repeat(A_host.indptr[:-1], lens)
        rows = A_host.rows_expanded()
        cols_np[rows, slot] = A_host.indices
        vals_np[rows, slot] = A_host.data
        dense = _extract_dense_blocks(cols_np, vals_np, ids, n)
    else:                                # big blocks: per-block extraction
        dense = np.zeros((nb, m, m))
        eye = np.eye(m)
        for k in range(nb):
            blk = ids[k][ids[k] < n]
            sz = len(blk)
            dense[k, :sz, :sz] = A_host.extract_submatrix(blk, blk)
            dense[k, sz:, sz:] = eye[sz:, sz:]
    inv = np.linalg.inv(dense)

    dof_ids, inv_blocks = [], []
    for c in range(int(colors.max()) + 1):
        sel = colors == c
        dof_ids.append(torch.as_tensor(ids[sel], dtype=torch.int64
                                       ).to(dev))
        inv_blocks.append(torch.as_tensor(inv[sel], dtype=dtype).to(dev))
    return SchwarzSmoother(dof_ids, inv_blocks, symmetric=symmetric,
                           additive=False, weight=weight)
