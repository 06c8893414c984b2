"""DIA (diagonal) sparse format on torch tensors.

Counterpart of the JAX package's ``sparse/dia.py``: the planes are one
(nd, n) tensor with data[d, i] = A[i, i + offsets[d]] (zero where out of
range), and ``matvec`` is the op-level sum of shifted slices, in the
data's dtype.  ``sparse.dia_kernels.KernelDIA`` runs the same format
through kernel K1.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .dia_kernels import dia_spmv_plain
from .host import HostCSR


class DIA:
    """offsets: static tuple of ints; data: (ndiags, n) tensor."""

    def __init__(self, offsets, data, shape, nnz=None):
        self.offsets = tuple(int(o) for o in offsets)
        self.data = data
        self.shape = tuple(shape)
        self.nnz = nnz if nnz is not None else int(
            torch.count_nonzero(data))

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def from_host(A: HostCSR, dtype=torch.float32, device=None) -> "DIA":
        n, m = A.shape
        assert n == m, "DIA path expects square operators"
        r, c, v = A.to_coo()
        offs = c - r
        uoffs = np.unique(offs)
        data = np.zeros((len(uoffs), n), dtype=np.float64)
        data[np.searchsorted(uoffs, offs), r] = v
        dev = kernels.resolve_device(device)
        return DIA(uoffs.tolist(),
                   torch.as_tensor(data).to(dtype).to(dev),
                   (n, n), nnz=A.nnz)

    def to_host(self) -> HostCSR:
        n = self.shape[0]
        data = self.data.float().cpu().numpy() \
            if self.data.dtype == torch.bfloat16 else \
            self.data.cpu().numpy()
        rows, cols, vals = [], [], []
        for d, off in enumerate(self.offsets):
            r = np.arange(max(0, -off), min(n, n - off))
            vv = data[d, r]
            keep = vv != 0
            rows.append(r[keep])
            cols.append(r[keep] + off)
            vals.append(vv[keep])
        return HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                                np.concatenate(vals), self.shape)

    def matvec(self, x):
        return dia_spmv_plain(self.offsets, self.data, x)

    def residual(self, x, b):
        """b - A @ x."""
        return dia_spmv_plain(self.offsets, self.data, x, b)

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.data.dtype,
                           device=self.data.device)


def dia_matvec_op(A: DIA):
    """The op-level matvec as a krylov-compatible callable."""
    return A.matvec
