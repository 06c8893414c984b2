"""DIA SpMV on the card: kernel K1 (csrc/dia.cu) and its plain version.

Counterpart of the JAX package's ``sparse/dia_pallas.py``.  ``KernelDIA``
takes PDIA's place: its ``matvec`` computes ``y = A x`` and its
``residual`` computes ``b - A x`` over static diagonal offsets, with the
planes held as one (nd, n) tensor, diagonal-major, in float32 or
bfloat16, and the sum taken in float32.  On a CUDA tensor the wrappers
launch K1; on a CPU tensor they run the plain version below (a sum of
shifted slices); on anything else they raise.

Also here, copied: the host helpers ``_cheb_coefs`` and ``blockinv_dia``
that the fused hierarchy uses.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .host import HostCSR


# ---------------------------------------------------------------------------
# K1 and its plain version
# ---------------------------------------------------------------------------

def dia_spmv_plain(offsets, planes, x, b=None, out=None):
    """sum_d planes[d] * x[i + offsets[d]] (zero outside [0, n)), or
    b minus that; accumulated in x's dtype (float32 for the kernel's
    inputs), the planes cast from their storage dtype."""
    n = x.shape[0]
    acc = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        if abs(off) >= n:
            continue
        p = planes[d].to(x.dtype)
        if off >= 0:
            acc[:n - off] += p[:n - off] * x[off:]
        else:
            acc[-off:] += p[-off:] * x[:n + off]
    y = acc if b is None else b - acc
    if out is None:
        return y
    return out.copy_(y)


def dia_spmv(offsets, planes, x, b=None, out=None):
    """y = A x (b is None) or y = b - A x, A in DIA planes (nd, n).

    CPU tensors: the plain version.  CUDA tensors: kernel K1, with x, b
    and out float32 and the planes float32 or bfloat16."""
    if x.device.type == "cpu":
        return dia_spmv_plain(offsets, planes, x, b, out)
    n = x.shape[0]
    nd = len(offsets)
    kernels.require(x, "x", dtype=torch.float32)
    kernels.require(planes, "planes", numel=nd * n, device=x.device)
    if b is not None:
        kernels.require(b, "b", dtype=torch.float32, numel=n,
                        device=x.device)
    if out is None:
        out = torch.empty_like(x)
    kernels.require(out, "out", dtype=torch.float32, numel=n,
                    device=x.device)
    if out.data_ptr() == x.data_ptr():
        raise ValueError("out must not alias x")
    name = "dia_spmv" if b is None else "dia_residual"
    rc = kernels.lib().tpuamg_dia_sweep(
        planes.data_ptr(), kernels.storage_flag(planes), x.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), n, nd,
        kernels.int_array(tuple(offsets)), kernels.stream_ptr())
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


class KernelDIA:
    """DIA operator whose matvec/residual run K1 on the card.

    planes: (nd, n) tensor, planes[d, i] = A[i, i + offsets[d]] (zero where
    out of range).  Duck-type compatible with sparse.dia.DIA on the solve
    path (matvec / residual / diagonal / shape / nnz / dtype)."""

    def __init__(self, offsets, planes, shape, nnz):
        self.offsets = tuple(int(o) for o in offsets)
        self.planes = planes
        self.shape = tuple(shape)
        self.nnz = int(nnz)

    @property
    def dtype(self):
        return self.planes.dtype

    @property
    def device(self):
        return self.planes.device

    @classmethod
    def from_dia(cls, D) -> "KernelDIA":
        return cls(D.offsets, D.data.contiguous(), D.shape, D.nnz)

    @classmethod
    def from_host(cls, A: HostCSR, dtype=torch.float32,
                  device=None) -> "KernelDIA":
        from .dia import DIA
        return cls.from_dia(DIA.from_host(A, dtype=dtype, device=device))

    def to_dia(self):
        from .dia import DIA
        return DIA(self.offsets, self.planes, self.shape, self.nnz)

    def to_host(self) -> HostCSR:
        return self.to_dia().to_host()

    def matvec(self, x):
        return dia_spmv(self.offsets, self.planes, x)

    def residual(self, x, b):
        """b - A @ x in one K1 launch."""
        return dia_spmv(self.offsets, self.planes, x, b)

    def diagonal(self):
        if 0 in self.offsets:
            return self.planes[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)


# ---------------------------------------------------------------------------
# Host helpers (copies)
# ---------------------------------------------------------------------------

def blockinv_dia(blockinv, mask=None):
    """Block-diagonal inverse (ng, F, F) as a (2F-1)-offset host-side DIA
    data array — so the smoother's B^{-1} apply is itself one DIA sweep.

    out[g*F + fi] = sum_fj blockinv[g, fi, fj] * r[g*F + fj]
    => offset o = fj - fi with plane c_o[i] = blockinv[i//F, i%F, i%F + o].
    mask (n,) rows are zeroed (ghost slots).  Returns (offsets, data)."""
    bi = np.asarray(blockinv)
    ng, F, _ = bi.shape
    n = ng * F
    offsets = list(range(-(F - 1), F))
    data = np.zeros((len(offsets), n))
    fi = np.arange(n) % F
    g = np.arange(n) // F
    for d, o in enumerate(offsets):
        fj = fi + o
        ok = (fj >= 0) & (fj < F)
        data[d, ok] = bi[g[ok], fi[ok], fj[ok]]
    if mask is not None:
        data *= np.asarray(mask)[None, :]
    return offsets, data


def _cheb_coefs(lmax, lmin, degree, kind=1):
    """Coefficients of the degree-`degree` polynomial smoother recurrence

        d_1 = r_0 / theta;   d_k = a_k d_{k-1} + c_k r_{k-1};  x += d_k

    kind=1: classical first-kind Chebyshev on [lmin, lmax].
    kind=4: fourth-kind Chebyshev (Lottes, 'Optimal polynomial smoothers
    for multigrid', arXiv:2202.08830): needs only the upper spectral bound
    (lmin ignored) and damps the whole [0, lmax] band."""
    if kind == 4:
        theta = 0.75 * lmax                       # d_1 = 4/(3 lmax) r_0
        coefs = []
        for k in range(1, degree):
            ak = (2.0 * k - 1.0) / (2.0 * k + 3.0)
            ck = (8.0 * k + 4.0) / ((2.0 * k + 3.0) * lmax)
            coefs.append((float(ak), float(ck)))
        return float(theta), tuple(coefs)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    coefs = []
    for _k in range(1, degree):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coefs.append((float(rho_new * rho), float(2.0 * rho_new / delta)))
        rho = rho_new
    return float(theta), tuple(coefs)
