"""Host-side sparse matrix toolkit (numpy, vectorized).

AMG *setup* runs on the host: it produces data-dependent shapes (aggregates,
per-level nnz) that cannot live under ``jit``.  Everything here is therefore
plain numpy, written with fully vectorized primitives (no per-row Python
loops) so setup stays fast even at 10^6 dofs.  The *solve* phase consumes the
results as static-shaped device arrays (see ``tpuamg_torch.sparse.dia``).

Re-implements the used surface of the reference's sparse stacks
(HAZmath ``dCSRmat``/``block_dCSRmat``, PETSc CSR; see SURVEY.md §2b):
conversions, SpMV, SpGEMM, transpose, triple products, block concatenation.
Reference call sites: reference ``utils.py:95-127`` (conversions),
reference ``emi_3d1d.py:21`` (block mats).

The C++ helpers of ``tpuamg_torch/native`` (COO coalesce, SpGEMM,
coloring) replace the hot paths where the library is available; the numpy
implementations are the plain route and the correctness oracle.
``TPUAMG_NO_NATIVE`` selects the numpy SpGEMM and coloring, as in the JAX
package.
"""
from __future__ import annotations

import os

import numpy as np


def _coalesce_coo(rows, cols, vals, shape):
    """Sort COO triplets by (row, col) and sum duplicates. Vectorized."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows) == 0:
        return rows, cols, vals
    # boundary where a new (row, col) starts
    new = np.empty(len(rows), dtype=bool)
    new[0] = True
    np.not_equal(rows[1:], rows[:-1], out=new[1:])
    new[1:] |= cols[1:] != cols[:-1]
    starts = np.flatnonzero(new)
    vals = np.add.reduceat(vals, starts)
    return rows[starts], cols[starts], vals


class HostCSR:
    """Minimal CSR container with vectorized kernels.

    Not a scipy wrapper: scipy.sparse is used only in tests as an oracle.
    """

    __slots__ = ("indptr", "indices", "data", "shape")

    def __init__(self, indptr, indices, data, shape):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.data = np.asarray(data)
        self.shape = tuple(shape)

    # -- constructors -------------------------------------------------
    @staticmethod
    def from_coo(rows, cols, vals, shape, sum_duplicates=True):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        if sum_duplicates:
            if vals.dtype == np.float64 and len(rows) > 4096:
                # native bucket-sort coalesce (the assembly hot path)
                from ..native import native_coo_to_csr
                nat = native_coo_to_csr(rows, cols, vals, shape)
                if nat is not None:
                    indptr, out_cols, out_vals = nat
                    return HostCSR(indptr, out_cols, out_vals, shape)
            rows, cols, vals = _coalesce_coo(rows, cols, vals, shape)
        else:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return HostCSR(indptr, cols.astype(np.int32), vals, shape)

    @staticmethod
    def eye(n, dtype=np.float64):
        return HostCSR(np.arange(n + 1), np.arange(n, dtype=np.int32),
                       np.ones(n, dtype=dtype), (n, n))

    @staticmethod
    def from_dense(a):
        a = np.asarray(a)
        rows, cols = np.nonzero(a)
        return HostCSR.from_coo(rows, cols, a[rows, cols], a.shape)

    # -- basics -------------------------------------------------------
    @property
    def nnz(self):
        return len(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    def copy(self):
        return HostCSR(self.indptr.copy(), self.indices.copy(),
                       self.data.copy(), self.shape)

    def astype(self, dtype):
        return HostCSR(self.indptr, self.indices, self.data.astype(dtype),
                       self.shape)

    def row_lengths(self):
        return np.diff(self.indptr)

    def rows_expanded(self):
        """Row index of every stored entry (COO row array)."""
        return np.repeat(np.arange(self.shape[0], dtype=np.int64),
                         self.row_lengths())

    def to_coo(self):
        return self.rows_expanded(), self.indices.astype(np.int64), self.data

    def toarray(self):
        out = np.zeros(self.shape, dtype=self.data.dtype)
        r, c, v = self.to_coo()
        np.add.at(out, (r, c), v)
        return out

    def diagonal(self):
        r, c, v = self.to_coo()
        d = np.zeros(min(self.shape), dtype=self.data.dtype)
        m = r == c
        d[r[m]] = v[m]
        return d

    # -- kernels ------------------------------------------------------
    def matvec(self, x):
        x = np.asarray(x)
        prod = self.data * x[self.indices]
        out = np.zeros(self.shape[0], dtype=np.result_type(self.data, x))
        np.add.at(out, self.rows_expanded(), prod)
        return out

    def transpose(self):
        r, c, v = self.to_coo()
        return HostCSR.from_coo(c, r, v, (self.shape[1], self.shape[0]),
                                sum_duplicates=False)

    @property
    def T(self):
        return self.transpose()

    def matmat(self, other: "HostCSR") -> "HostCSR":
        """SpGEMM C = self @ other.

        Dispatches to the native C++ Gustavson kernel (tpuamg_torch/native)
        when available; else a vectorized numpy expansion (each stored
        a_ij expands B's row j; coalesce by (row, col))."""
        assert self.shape[1] == other.shape[0], (self.shape, other.shape)
        if not os.environ.get("TPUAMG_NO_NATIVE"):
            from ..native import native_spgemm
            out = native_spgemm(self, other)
            if out is not None:
                return out
        a_rows = self.rows_expanded()
        j = self.indices.astype(np.int64)
        b_start = other.indptr[j]
        lens = (other.indptr[j + 1] - b_start).astype(np.int64)
        total = int(lens.sum())
        if total == 0:
            return HostCSR.from_coo(
                np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, self.data.dtype),
                (self.shape[0], other.shape[1]))
        # flat[k] walks through each B-row segment:
        # offsets per product entry via cumsum trick
        seg_id = np.repeat(np.arange(len(lens)), lens)
        seg_off = np.arange(total) - np.repeat(
            np.cumsum(lens) - lens, lens)
        flat = b_start[seg_id] + seg_off
        out_rows = a_rows[seg_id]
        out_cols = other.indices[flat].astype(np.int64)
        out_vals = self.data[seg_id] * other.data[flat]
        return HostCSR.from_coo(out_rows, out_cols, out_vals,
                                (self.shape[0], other.shape[1]))

    def __matmul__(self, other):
        if isinstance(other, HostCSR):
            return self.matmat(other)
        return self.matvec(other)

    def add(self, other: "HostCSR", alpha=1.0, beta=1.0):
        assert self.shape == other.shape
        r1, c1, v1 = self.to_coo()
        r2, c2, v2 = other.to_coo()
        return HostCSR.from_coo(
            np.concatenate([r1, r2]), np.concatenate([c1, c2]),
            np.concatenate([alpha * v1, beta * v2]), self.shape)

    def __add__(self, other):
        return self.add(other)

    def scale(self, alpha):
        return HostCSR(self.indptr, self.indices, alpha * self.data,
                       self.shape)

    def __mul__(self, alpha):
        return self.scale(alpha)

    __rmul__ = __mul__

    def scale_rows(self, d):
        """diag(d) @ A."""
        return HostCSR(self.indptr, self.indices,
                       np.repeat(np.asarray(d), self.row_lengths())
                       * self.data, self.shape)

    def scale_cols(self, d):
        """A @ diag(d)."""
        return HostCSR(self.indptr, self.indices,
                       np.asarray(d)[self.indices] * self.data, self.shape)

    def extract_submatrix(self, rows, cols):
        """Dense block A[rows][:, cols] (for Schwarz / coarse solves)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        colmap = np.full(self.shape[1], -1, dtype=np.int64)
        colmap[cols] = np.arange(len(cols))
        out = np.zeros((len(rows), len(cols)), dtype=self.data.dtype)
        for ii, r in enumerate(rows):  # rows are small blocks; fine
            sl = slice(self.indptr[r], self.indptr[r + 1])
            cc = colmap[self.indices[sl]]
            m = cc >= 0
            out[ii, cc[m]] = self.data[sl][m]
        return out

    def drop_zeros(self, tol=0.0):
        r, c, v = self.to_coo()
        m = np.abs(v) > tol
        return HostCSR.from_coo(r[m], c[m], v[m], self.shape,
                                sum_duplicates=False)

    def eliminate_rows_cols(self, dofs, diag_value=1.0):
        """Symmetric elimination: zero rows+cols of `dofs`, put diag_value
        on their diagonal. Returns (newA, colA) where colA holds the
        eliminated *columns* (needed to lift boundary data into the RHS:
        b <- b - colA @ g). Mirrors xii.apply_bc semantics
        (reference bidomain_2d.py:97).

        Direct CSR filtering (boolean masks preserve the per-row column
        order, so no re-sort/coalesce pass is needed — the COO+from_coo
        version was an assembly-profile hot spot at n=512)."""
        n = self.shape[0]
        is_bc = np.zeros(n, dtype=bool)
        is_bc[np.asarray(dofs, dtype=np.int64)] = True
        rows = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(self.indptr))
        bc_r = is_bc[rows]
        bc_c = is_bc[self.indices]
        col_part = bc_c & ~bc_r
        colA = _csr_from_mask(rows, self.indices, self.data, col_part,
                              self.shape)
        # newA: non-bc rows keep their non-bc-column entries (in order);
        # bc rows hold exactly the diagonal entry.
        keep = ~(bc_r | bc_c)
        k_rows = rows[keep]
        counts = np.bincount(k_rows, minlength=n)
        counts[is_bc] = 1
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        nnz = int(indptr[-1])
        out_ix = np.empty(nnz, dtype=np.int32)
        out_dt = np.empty(nnz, dtype=self.data.dtype)
        # kept entries: grouped by row and column-sorted already;
        # bc rows have zero kept entries, so no interleaving
        pos = np.arange(len(k_rows), dtype=np.int64)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(np.bincount(k_rows, minlength=n)[:-1], out=starts[1:])
        dest = indptr[k_rows] + (pos - starts[k_rows])
        out_ix[dest] = self.indices[keep]
        out_dt[dest] = self.data[keep]
        dr = np.flatnonzero(is_bc)
        out_ix[indptr[dr]] = dr.astype(np.int32)
        out_dt[indptr[dr]] = diag_value
        return HostCSR(indptr, out_ix, out_dt, self.shape), colA


def _csr_from_mask(rows, indices, data, mask, shape):
    """CSR from entry-mask over (rows ascending, cols sorted per row)
    parallel arrays — boolean indexing preserves both orders, so no sort."""
    r = rows[mask]
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=shape[0]), out=indptr[1:])
    return HostCSR(indptr, indices[mask], data[mask], shape)


# ---------------------------------------------------------------------------
# Block operations (reference: block_dCSRmat, ii_convert)
# ---------------------------------------------------------------------------

def bmat(blocks) -> HostCSR:
    """Concatenate a 2D list of HostCSR / None into one monolithic HostCSR.

    Equivalent of ``xii.ii_convert`` on a block operator
    (reference bidomain_2d.py:178).
    """
    nbr = len(blocks)
    nbc = len(blocks[0])
    row_sizes = [None] * nbr
    col_sizes = [None] * nbc
    for i in range(nbr):
        for j in range(nbc):
            b = blocks[i][j]
            if b is None:
                continue
            row_sizes[i] = b.shape[0]
            col_sizes[j] = b.shape[1]
    assert all(s is not None for s in row_sizes), "empty block row"
    assert all(s is not None for s in col_sizes), "empty block col"
    roff = np.concatenate([[0], np.cumsum(row_sizes)])
    coff = np.concatenate([[0], np.cumsum(col_sizes)])
    # Direct CSR concatenation: blocks occupy disjoint column ranges and
    # each block's rows are already column-sorted, so appending block j's
    # row slice after block j-1's keeps every output row sorted — no COO
    # round trip / re-sort (the from_coo version was an n=512 assembly
    # profile hot spot).
    n_out = int(roff[-1])
    nnz = sum(b.nnz for row in blocks for b in row if b is not None)
    indptr = np.zeros(n_out + 1, dtype=np.int64)
    out_ix = np.empty(nnz, dtype=np.int32)
    out_dt = np.empty(
        nnz, dtype=np.result_type(*[b.data.dtype for row in blocks
                                    for b in row if b is not None]))
    for i in range(nbr):
        bs = [(j, blocks[i][j]) for j in range(nbc)
              if blocks[i][j] is not None]
        nr = int(row_sizes[i])
        counts = np.zeros(nr, dtype=np.int64)
        for _, b in bs:
            counts += np.diff(b.indptr)
        sl = slice(int(roff[i]) + 1, int(roff[i]) + nr + 1)
        indptr[sl] = indptr[int(roff[i])] + np.cumsum(counts)
        base = indptr[int(roff[i]):int(roff[i]) + nr]  # row starts
        prefix = np.zeros(nr, dtype=np.int64)
        for j, b in bs:
            cnt = np.diff(b.indptr)
            dest = (np.repeat(base + prefix, cnt)
                    + (np.arange(b.nnz, dtype=np.int64)
                       - np.repeat(b.indptr[:-1], cnt)))
            out_ix[dest] = b.indices + np.int32(coff[j])
            out_dt[dest] = b.data
            prefix += cnt
    return HostCSR(indptr, out_ix, out_dt, (n_out, int(coff[-1])))


def pad_csr_identity(A: HostCSR, multiple: int) -> HostCSR:
    """Pad a square matrix with identity rows/cols so the size becomes a
    multiple of `multiple` (device-mesh divisibility for row sharding).
    Identity pad rows are inert: zero RHS keeps them at zero through
    smoothing, and the aggregation path batches them like eliminated
    Dirichlet rows."""
    n = A.shape[0]
    n2 = ((n + multiple - 1) // multiple) * multiple
    if n2 == n:
        return A
    r, c, v = A.to_coo()
    extra = np.arange(n, n2)
    return HostCSR.from_coo(
        np.concatenate([r, extra]), np.concatenate([c, extra]),
        np.concatenate([v, np.ones(n2 - n, dtype=A.data.dtype)]),
        (n2, n2), sum_duplicates=False)


def extract_diag_blocks(A: HostCSR, sizes):
    """Split a monolithic matrix back into its diagonal blocks
    (inverse companion of bmat for block-diag preconditioning)."""
    offs = np.concatenate([[0], np.cumsum(sizes)])
    r, c, v = A.to_coo()
    out = []
    for i in range(len(sizes)):
        lo, hi = offs[i], offs[i + 1]
        m = (r >= lo) & (r < hi) & (c >= lo) & (c < hi)
        out.append(HostCSR.from_coo(r[m] - lo, c[m] - lo, v[m],
                                    (sizes[i], sizes[i]),
                                    sum_duplicates=False))
    return out


def rap(R: HostCSR, A: HostCSR, P: HostCSR) -> HostCSR:
    """Galerkin triple product R @ A @ P."""
    return R.matmat(A.matmat(P))


def rap_unsmoothed(A: HostCSR, agg: np.ndarray, nagg: int) -> HostCSR:
    """Galerkin product P^T A P for a piecewise-constant (unsmoothed
    aggregation) P given by the aggregate map ``agg`` (agg[i] = coarse id,
    -1 = unaggregated/dropped). Pure relabel+coalesce — much faster than two
    general SpGEMMs."""
    r, c, v = A.to_coo()
    cr = agg[r]
    cc = agg[c]
    m = (cr >= 0) & (cc >= 0)
    return HostCSR.from_coo(cr[m], cc[m], v[m], (nagg, nagg))


def greedy_color(A: HostCSR, max_colors=24) -> np.ndarray:
    """Greedy graph coloring of the symmetric sparsity pattern of A.

    Used to build multicolor Gauss-Seidel sweeps (the parallel stand-in
    for HAZmath's sequential SGS smoother, SURVEY.md §7 risk list).
    Returns color[i] in [0, ncolors].  Rows that would need more than
    `max_colors` colors (near-dense rows, e.g. 3D dofs coupled through a
    cylinder-average operator) are assigned the overflow color
    ``max_colors``; the smoother builder damps those rows l1-Jacobi-style,
    which is convergent regardless of neighbors sharing the group."""
    if not os.environ.get("TPUAMG_NO_NATIVE"):
        from ..native import native_greedy_color
        out = native_greedy_color(A, max_colors)
        if out is not None:
            return out
    n = A.shape[0]
    colors = np.full(n, -1, dtype=np.int32)
    indptr, indices = A.indptr, A.indices
    order = np.argsort(-A.row_lengths(), kind="stable")  # high degree first
    for i in order:
        nbr = indices[indptr[i]:indptr[i + 1]]
        used = set(colors[nbr[nbr != i]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[i] = min(c, max_colors)
    return colors
