"""Device-resident padded ELL matrices and their SpMV, as torch tensors.

Counterpart of the JAX package's ``sparse/device.py``: dense ``(n, L)``
column-index and value planes (L = max row nnz); padded slots point at the
ghost column ``m`` and hold zeros, and every product pads x with one
trailing zero, so a SpMV is a gather, a multiply and a row sum.  The
algebraic metric-AMG path (levels, transfers, smoothers, the outer
operator) runs on these; its device work is plain torch ops, as the JAX
package's is XLA ops outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import resolve_device
from .host import HostCSR


def _pad(x):
    return torch.cat([x, x.new_zeros(1)])


class ELL:
    """Padded ELL sparse matrix on a device.

    cols: (n, L) int64 — column index per slot; padded slots hold
          ``shape[1]`` (the ghost slot of the zero-padded x).
    vals: (n, L) float — value per slot; padded slots are 0.
    """

    def __init__(self, cols, vals, shape, nnz=None):
        self.cols = cols
        self.vals = vals
        self.shape = tuple(shape)
        self.nnz = nnz if nnz is not None else int((vals != 0).sum())

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def row_width(self):
        return self.cols.shape[1]

    @staticmethod
    def from_host(A: HostCSR, dtype=torch.float32, width=None,
                  device=None) -> "ELL":
        n, m = A.shape
        lens = A.row_lengths()
        L = int(lens.max()) if len(lens) and lens.max() > 0 else 1
        if width is not None:
            assert width >= L, (width, L)
            L = width
        cols = np.full((n, L), m, dtype=np.int64)  # ghost column
        vals = np.zeros((n, L), dtype=np.float64)
        # slot index of each nnz within its row
        slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(A.indptr[:-1],
                                                           lens)
        rows = A.rows_expanded()
        cols[rows, slot] = A.indices
        vals[rows, slot] = A.data
        dev = resolve_device(device)
        return ELL(torch.from_numpy(cols).to(dev),
                   torch.from_numpy(vals).to(dtype).to(dev), (n, m),
                   nnz=A.nnz)

    def to_host(self) -> HostCSR:
        cols = self.cols.cpu().numpy()
        vals = self.vals.double().cpu().numpy()
        _, m = self.shape
        r, s = np.nonzero(cols != m)
        return HostCSR.from_coo(r, cols[r, s], vals[r, s], self.shape)

    def to(self, device) -> "ELL":
        return ELL(self.cols.to(device), self.vals.to(device), self.shape,
                   self.nnz)

    # -- device products ---------------------------------------------
    def matvec(self, x):
        """y = A @ x.  x: (m,) -> (n,)."""
        return torch.sum(self.vals * _pad(x)[self.cols], dim=1)

    def __matmul__(self, x):
        return self.matvec(x)

    def residual(self, x, b):
        """b - A @ x (duck-type parity with DIA)."""
        return b - self.matvec(x)

    def matvec_rows(self, x, row_ids):
        """(A @ x)[row_ids] without touching other rows."""
        return torch.sum(self.vals[row_ids] * _pad(x)[self.cols[row_ids]],
                         dim=1)

    def diagonal(self):
        n = self.shape[0]
        rows = torch.arange(n, device=self.cols.device)[:, None]
        hit = self.cols == rows
        return torch.sum(torch.where(hit, self.vals,
                                     torch.zeros_like(self.vals)), dim=1)

    def l1_row_norms(self):
        return torch.sum(torch.abs(self.vals), dim=1)

    def astype(self, dtype):
        return ELL(self.cols, self.vals.to(dtype), self.shape, self.nnz)


def matvec_op(A: ELL):
    """The matrix as a krylov-compatible callable."""
    return A.matvec


def ell_rows(A: ELL, row_ids) -> ELL:
    """Row slice of an ELL matrix (row_ids concrete, on the host)."""
    ids = torch.as_tensor(np.asarray(row_ids), dtype=torch.int64,
                          device=A.cols.device)
    return ELL(A.cols[ids], A.vals[ids], (len(ids), A.shape[1]))
