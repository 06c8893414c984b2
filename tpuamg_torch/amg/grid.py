"""Grid-structured hierarchy: reshape-based geometric transfers with
Galerkin (algebraic) coarse operators.

Counterpart of the JAX package's ``amg/grid.py``.  Dofs are kept in
lexicographic grid order with the F fields of a node interleaved, so every
level's operator is a DIA with ~stencil-many offsets, and 2x2(x2) window
aggregation is a pure reshape:

    restrict: (ny, nx, F) -> pad-to-even -> (ny/2, 2, nx/2, 2, F).sum
    prolong:  repeat back, crop

Coarse operators are Galerkin products of the true matrix (masked rows
excluded), the level smoother is Chebyshev on the exactly inverted F x F
node blocks, and the coarse solve is a dense inverse.

``setup_grid`` returns an ``amg.hierarchy.MGPreconditioner`` (route (c)
of ``problems.solve.solve_system``'s grid branch).  Which smoother and
operator a level gets follows the JAX package's ``resolve_pallas`` rule
on its accelerator, as ``use_kernels`` states it: f32/bf16 data runs the
kernels (``KernelDIA`` -> K1, ``FusedChebSmoother`` -> K3), f64 data and
``pallas=False`` run the plain torch classes, and ``pallas=True`` with f64
data raises.  The device only decides how a kernel class runs: its
kernel on a CUDA tensor, its plain version on a CPU tensor.

Also here, for the fused hierarchy (``amg/grid_fused.py``): the field
interleave, the window-coarse operator, the node-block inverses and the
power-iteration bound of the block-Jacobi-preconditioned operator (same
seed as the JAX package, so the Chebyshev interval matches).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import AMGParameters
from ..sparse import HostCSR
from ..sparse.dia import DIA
from ..sparse.dia_kernels import FusedChebSmoother, KernelDIA, blockinv_dia
from .hierarchy import MGPreconditioner
from .structured import BlockChebyshevSmoother


class ChebyshevDiagSmoother:
    """Chebyshev on D^{-1}A with a masked diagonal (F = 1 levels)."""

    def __init__(self, invd, mask, lmax, lmin, degree=3, kind=1):
        self.invd = invd
        self.mask = mask
        self.lmax = lmax
        self.lmin = lmin
        self.degree = degree
        self.kind = kind

    def _binv(self, r):
        return self.invd.to(r.dtype) * r * self.mask.to(r.dtype)

    smooth = BlockChebyshevSmoother.smooth   # same recurrence


class GridLevel:
    """MG level over a (dims) grid with F fields per node.

    Vector layout: fields fastest, then grid axes lex (last axis fastest):
    flat index = ((i0*d1 + i1)*... )*F + f.  Transfers halve each grid
    axis and keep the field axis (the coarse space must represent each
    field separately, or the u1-u2 component loses its coarse correction
    at small gamma).  ``dtype`` is the compute dtype of the level (the
    mask's); A may be stored narrower."""

    def __init__(self, A, smoother, mask, dims, F):
        self.A = A
        self.smoother = smoother
        self.mask = mask
        self.dims = tuple(dims)
        self.F = F
        cd = tuple((d + 1) // 2 for d in dims)
        self.cdims = cd
        self.nc = int(np.prod(cd)) * F

    @property
    def dtype(self):
        return self.mask.dtype

    def restrict(self, r):
        return window_sum(r * self.mask, self.dims, self.F)

    def prolong(self, ec):
        return window_spread(ec, self.dims, self.F).reshape(-1) * self.mask


def window_sum(r, dims, F):
    """The 2^d window sums of a flat (dims, F) vector: pad odd axes with
    a zero row, then sum pairs along every grid axis; flat result."""
    g = r.reshape(tuple(dims) + (F,))
    for ax, d in enumerate(dims):
        if d % 2:
            pad = list(g.shape)
            pad[ax] = 1
            g = torch.cat([g, g.new_zeros(pad)], dim=ax)
    for ax in range(len(dims)):
        d2 = (dims[ax] + 1) // 2
        shape = g.shape[:ax] + (d2, 2) + g.shape[ax + 1:]
        g = g.reshape(shape).sum(dim=ax + 1)
    return g.reshape(-1)


def window_spread(ec, dims, F):
    """The transpose of window_sum: each coarse entry repeated over its
    window, cropped to dims; returns the (dims, F) grid."""
    cdims = tuple((d + 1) // 2 for d in dims)
    g = ec.reshape(cdims + (F,))
    for ax in range(len(dims)):
        g = g.repeat_interleave(2, dim=ax).narrow(ax, 0, dims[ax])
    return g


def interleave_fields(nv, F):
    """slots[f*nv + v] = v*F + f — per-node field interleave."""
    v = np.arange(nv)
    slots = np.empty(nv * F, dtype=np.int64)
    for f in range(F):
        slots[f * nv:(f + 1) * nv] = v * F + f
    return slots


def _grid_coarse(A: HostCSR, mask, dims, F):
    """Galerkin window-coarse operator: aggregate = (2^d grid-cell window,
    field) — the field axis is preserved.  Masked rows excluded; empty
    aggregates become identity rows with mask 0."""
    d = len(dims)
    cdims = tuple((x + 1) // 2 for x in dims)
    n = A.shape[0]
    idx = np.arange(n)
    f = idx % F
    node = idx // F
    coords = []
    rem = node
    for ax in reversed(range(d)):
        coords.append(rem % dims[ax])
        rem //= dims[ax]
    coords = coords[::-1]                   # coords[ax]
    cnode = 0
    for ax in range(d):
        cnode = cnode * cdims[ax] + coords[ax] // 2
    agg = cnode * F + f
    r, c, v = A.to_coo()
    real = (mask[r] > 0) & (mask[c] > 0)
    nc = int(np.prod(cdims)) * F
    sums = np.bincount(agg, weights=mask, minlength=nc)
    mask_c = (sums > 0).astype(np.float64)
    dead = np.flatnonzero(mask_c == 0)
    Ac = HostCSR.from_coo(
        np.concatenate([agg[r[real]], dead]),
        np.concatenate([agg[c[real]], dead]),
        np.concatenate([v[real], np.ones(len(dead))]), (nc, nc))
    return Ac, mask_c, cdims


def _permute(A: HostCSR, slots, n_out):
    r, c, v = A.to_coo()
    return HostCSR.from_coo(slots[r], slots[c], v, (n_out, n_out))


def _node_blocks(A: HostCSR, F):
    """Inverses of the F x F node blocks (zero diagonals replaced by 1)."""
    n = A.shape[0]
    ng = n // F
    r, c, v = A.to_coo()
    inblk = (r // F) == (c // F)
    blocks = np.zeros((ng, F, F))
    blocks[r[inblk] // F, r[inblk] % F, c[inblk] % F] = v[inblk]
    idx = np.arange(F)
    diag = blocks[:, idx, idx]
    blocks[:, idx, idx] = np.where(diag == 0, 1.0, diag)
    return np.linalg.inv(blocks)


def _lmax_blockinv(A: HostCSR, apply_binv, mask, iters=15, seed=0):
    """Power-iteration estimate of lambda_max(B^-1 A) on the masked
    space, from the same seeded start vector as the JAX package."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0]) * mask
    lam = 1.0
    for _ in range(iters):
        y = apply_binv(A.matvec(x)) * mask
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


def use_kernels(pallas, dtype) -> bool:
    """Whether the grid path builds its kernel classes: the JAX package's
    ``resolve_pallas`` rule on its accelerator.  ``pallas=False`` forces
    the plain torch classes; otherwise f32/bf16 data gets the kernels and
    f64 data the plain classes (there is no f64 kernel, in either
    package), except that ``pallas=True`` with f64 data raises
    ValueError rather than run the plain classes under the kernels' name.
    It never depends on whether a card is present."""
    if pallas is False:
        return False
    narrow = torch.empty((), dtype=dtype).element_size() <= 4
    if pallas is True and not narrow:
        raise ValueError(f"pallas=True needs float32 or bfloat16 data: "
                         f"no kernel takes {dtype}")
    return narrow


def _on(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(device)


def setup_grid(A_host: HostCSR, dims, F=1, mask=None,
               params: AMGParameters = AMGParameters(),
               dtype=torch.float32, cheb_degree=3, cheb_ratio=8.0,
               cheb_kind=1, storage_dtype=None, pallas=None, device=None):
    """Build the grid hierarchy for a field-stacked structured-grid system.

    A_host: monolithic operator in *field-major* order ([u1-block;
    u2-...]); dims: grid dims (points per axis, last axis fastest in
    vertex order); F: number of fields.  Returns (prec, slots, n) with
    slots the field-interleave permutation (applied outside the solve).

    storage_dtype: optional narrower dtype (e.g. torch.bfloat16) for the
    DIA planes and block inverses; arithmetic runs in `dtype`.
    pallas: None / True / False, see ``use_kernels``.
    device: None = the CUDA card; "cpu" runs the plain versions."""
    dev = kernels.resolve_device(device)
    kern = use_kernels(pallas, dtype)
    nv = int(np.prod(dims))
    assert A_host.shape[0] == nv * F
    slots = interleave_fields(nv, F)
    A = _permute(A_host, slots, nv * F)
    if mask is None:
        mask_np = np.ones(nv * F)
    else:
        mask_np = np.zeros(nv * F)
        mask_np[slots] = np.asarray(mask, dtype=np.float64)

    levels = []
    dims_cur = tuple(dims)
    sdtype = storage_dtype or dtype
    while (len(levels) < params.max_levels - 1
           and mask_np.sum() > params.coarse_dof):
        if F > 1:
            blockinv = _node_blocks(A, F)

            def apply_binv(r, bi=blockinv, s=F):
                return np.einsum("bij,bj->bi", bi,
                                 r.reshape(-1, s)).reshape(-1)
            lmax = _lmax_blockinv(A, apply_binv, mask_np)
        else:
            dg = A.diagonal().copy()
            dg[dg == 0] = 1.0
            blockinv = (1.0 / dg).reshape(-1, 1, 1)

            def apply_binv(r, iv=1.0 / dg):
                return iv * r
            lmax = _lmax_blockinv(A, apply_binv, mask_np)
        interval = (1.1 * lmax, 1.1 * lmax / cheb_ratio)
        if kern:
            # the whole degree-k sweep is one K3 launch
            coffs, cdata = blockinv_dia(blockinv, mask_np)
            Adev = KernelDIA.from_host(A, dtype=sdtype, device=dev)
            C = DIA(coffs, _on(cdata, sdtype, dev), A.shape)
            smoother = FusedChebSmoother.build(
                Adev, C, *interval, cheb_degree, kind=cheb_kind)
        elif F > 1:
            smoother = BlockChebyshevSmoother(
                _on(blockinv, sdtype, dev), _on(mask_np, dtype, dev),
                *interval, cheb_degree, kind=cheb_kind)
            Adev = DIA.from_host(A, dtype=sdtype, device=dev)
        else:
            smoother = ChebyshevDiagSmoother(
                _on(blockinv.reshape(-1), dtype, dev),
                _on(mask_np, dtype, dev), *interval, cheb_degree,
                kind=cheb_kind)
            Adev = DIA.from_host(A, dtype=sdtype, device=dev)
        levels.append(GridLevel(Adev, smoother, _on(mask_np, dtype, dev),
                                dims_cur, F))
        A, mask_np, dims_cur = _grid_coarse(A, mask_np, dims_cur, F)

    coarse_inv = np.linalg.inv(A.toarray()) if A.shape[0] else \
        np.zeros((0, 0))
    prec = MGPreconditioner(
        tuple(levels), _on(coarse_inv, dtype, dev),
        cycle=params.cycle_type, maxit=params.maxit,
        presmooth=params.presmooth_iter, postsmooth=params.postsmooth_iter,
        amli_degree=params.amli_degree, max_w_work=params.max_w_work,
        # AMG_coarse_scaling is pinned off on the whole grid path: the
        # fused cycle implements the unscaled cycle, and this hierarchy
        # must stay interchangeable with it
        coarse_scaling=False)
    return prec, slots, nv * F


def grid_system(A_host: HostCSR, slots, dtype=torch.float32, pallas=None,
                device=None):
    """Outer operator in interleaved order: a KernelDIA (K1) for f32/bf16
    data, a plain DIA for f64 data or with pallas=False."""
    n = A_host.shape[0]
    Ap = _permute(A_host, slots, n)
    if use_kernels(pallas, dtype):
        return KernelDIA.from_host(Ap, dtype=dtype, device=device)
    return DIA.from_host(Ap, dtype=dtype, device=device)
