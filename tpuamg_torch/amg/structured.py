"""Polynomial smoothers of the structured hierarchies, in torch ops.

Counterpart of the smoother classes at the top of the JAX package's
``amg/structured.py`` (lines 57-128).  Both run the degree-k Chebyshev
recurrence on B^{-1} A, B the nodal block diagonal:

    d_1 = B^{-1}(b - A x) / theta;  d_k = a_k d_{k-1} + c_k B^{-1}(b - A x)

with x += d after every step and the coefficients of
``sparse.dia_kernels._cheb_coefs``.  ``BlockChebyshevSmoother`` applies
B^{-1} as batched F x F blocks; ``DiaChebyshevSmoother`` as a
(2F-1)-offset DIA operator (``blockinv_dia``).  Both are plain torch ops:
the grid path uses them for f64 data and with ``pallas=False``; for
f32/bf16 data it uses ``sparse.dia_kernels.FusedChebSmoother``, whose
sweep is kernel K3.  The rest of the JAX module (the pair+Morton
hierarchy) is ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import torch

from ..sparse.dia_kernels import _cheb_coefs


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
