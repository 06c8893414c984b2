"""Fused grid hierarchy: one whole multigrid cycle z = M b on the card.

Counterpart of the JAX package's ``amg/grid_fused.py``.  The hierarchy is
the same: a structured grid with F fields per node, leading axes padded to
a multiple of 2^depth, the lane (last) axis padded to even per level,
Galerkin window-coarse operators, a (2F-1)-offset nodal block inverse as
the Chebyshev preconditioner, and a dense coarse inverse T.

Layout: the kernel-flat index space of the JAX package, in which dof
(i_lead..., ix, f) of a level lives at ``lead_lex * K * 128 + ix*F + f``
with ``K = ceil(dx_p * F / 128)`` lane chunks per grid row; the operators
stay DIA there and ``slots`` maps canonical dofs into it.  Each level
holds ``rows = prod(lead) * K`` rows of 128 and no further padding; its A
and C planes are contiguous (nd, rows*128) tensors, diagonal-major.

The cycle (``vcycle``) is one sequence of host calls over those tensors.
With CUDA tensors every step is a hand-written kernel (K1 in
csrc/dia.cu for the t-passes and residuals, K2's pieces in
csrc/vcycle.cu for the Chebyshev C-apply, restriction, prolongation and
coarse GEMV); with CPU tensors the same sequence runs the plain torch
versions defined here (``vcycle_plain`` runs them on any device).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..config import AMGParameters
from ..kernels import LANES
from ..sparse import HostCSR
from ..sparse.dia_kernels import (KernelDIA, _cheb_coefs, blockinv_dia,
                                  dia_spmv, dia_spmv_plain)
from .grid import _grid_coarse, _lmax_blockinv


def _round_up(x, m):
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Layout planning (copies)
# ---------------------------------------------------------------------------

def dims_schedule(dims, F, max_levels, coarse_dof):
    """Per-level padded dims for the fused hierarchy.

    Leading axes are padded once (at level 0) to a multiple of 2^depth so
    that halving keeps them even down to the coarsest level; the lane
    (last) axis is padded to even independently at each level.  Returns a
    list of dim tuples, one per level (levels[0..depth-1] smoothed,
    levels[depth] = coarse)."""
    dims = tuple(int(d) for d in dims)
    depth = 0
    cur = list(dims)
    while depth < max_levels - 1 and int(np.prod(cur)) * F > coarse_dof:
        cur = [(d + 1) // 2 for d in cur]
        depth += 1
    if depth == 0:
        return [dims]
    lead = [_round_up(d, 2 ** depth) for d in dims[:-1]]
    out = []
    dx = dims[-1]
    for lvl in range(depth + 1):
        dxp = dx + (dx % 2) if lvl < depth else dx
        out.append(tuple(lead) + (dxp,))
        lead = [d // 2 for d in lead]
        dx = dxp // 2
    return out


def _kernel_slots(dims_p, F, K):
    """Canonical (field-interleaved lex over dims_p) -> kernel flat index."""
    n = int(np.prod(dims_p)) * F
    idx = np.arange(n)
    f = idx % F
    node = idx // F
    ix = node % dims_p[-1]
    lead = node // dims_p[-1]
    lane_x = ix * F + f
    row = lead * K + lane_x // LANES
    return row * LANES + lane_x % LANES


def _embed_coo(A: HostCSR, slots, n_out) -> HostCSR:
    r, c, v = A.to_coo()
    return HostCSR.from_coo(slots[r], slots[c], v, (n_out, n_out))


def _dia_np(A: HostCSR):
    """DIA extraction on the host: (offsets tuple, (nd, n) float64)."""
    n = A.shape[0]
    r, c, v = A.to_coo()
    offs = c - r
    uoffs = np.unique(offs)
    data = np.zeros((len(uoffs), n))
    data[np.searchsorted(uoffs, offs), r] = v
    return tuple(int(o) for o in uoffs), data


def _dia_to_coo(offsets, data, n):
    rows, cols, vals = [], [], []
    for d, off in enumerate(offsets):
        r = np.arange(max(0, -off), min(n, n - off))
        vv = data[d, r]
        keep = vv != 0
        rows.append(r[keep])
        cols.append(r[keep] + off)
        vals.append(vv[keep])
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


def _pad_lane_axis(A: HostCSR, mask, dims_cur, dx_new, F):
    """Embed operator on dims_cur into dims with last axis padded to
    dx_new (pad dofs: empty rows, mask 0)."""
    dims_new = dims_cur[:-1] + (dx_new,)
    n_old = int(np.prod(dims_cur)) * F
    n_new = int(np.prod(dims_new)) * F
    idx = np.arange(n_old)
    f = idx % F
    node = idx // F
    coords = np.unravel_index(node, dims_cur)
    pnode = np.ravel_multi_index(coords, dims_new)
    slots = pnode * F + f
    A2 = _embed_coo(A, slots, n_new)
    m2 = np.zeros(n_new)
    m2[slots] = mask
    return A2, m2


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


@dataclass(frozen=True)
class LevelSpec:
    lead: tuple          # leading (non-lane) padded dims
    K: int               # lane chunks per grid row
    rows: int            # flat rows = prod(lead) * K; n = rows * 128
    offsA: tuple
    offsC: tuple
    theta: float
    coefs: tuple
    degree: int
    pre: int
    post: int

    @property
    def n(self):
        return self.rows * LANES


@dataclass(frozen=True)
class CycleSpec:
    levels: tuple        # per-level LevelSpec
    F: int               # fields per grid node
    Kc: int              # coarse level lane chunks
    rows_c: int          # coarse rows
    nc: int              # coarse flat size = rows_c * 128
    cycle: str = "v"     # "v" | "w" (two visits per level while
    #                      2^level <= max_w_work, the second warm)
    max_w_work: int = 64


# ---------------------------------------------------------------------------
# Cycle steps: plain torch versions
# ---------------------------------------------------------------------------

def cheb_apply_plain(offs, cplanes, t, d, x, first, s, c):
    """d = s * C t (first) or s * d + c * C t;  x += d."""
    ct = dia_spmv_plain(offs, cplanes, t)
    if first:
        d.copy_(s * ct)
    else:
        d.copy_(s * d + c * ct)
    x += d


def restrict_plain(spec: CycleSpec, lv, t, out):
    """out (next level's rows * 128) = pair sums of t over every leading
    axis and over x-node pairs of one field; lanes past the fine row's
    reach stay 0."""
    S = spec.levels[lv]
    Kc = spec.levels[lv + 1].K if lv + 1 < len(spec.levels) else spec.Kc
    F = spec.F
    lead = S.lead
    g = t[:S.n].view(*lead, S.K * LANES)
    for ax in range(len(lead)):
        g = g.reshape(g.shape[:ax] + (g.shape[ax] // 2, 2)
                      + g.shape[ax + 1:]).sum(ax + 1)
    half = S.K * LANES // 2
    clead = g.shape[:-1]
    g = g.reshape(*clead, half // F, 2, F).sum(-2).reshape(*clead, half)
    o = out.view(*clead, Kc * LANES)
    o[..., :half] = g
    o[..., half:] = 0.0


def prolong_plain(spec: CycleSpec, lv, x, mask, src):
    """x += mask * (src duplicated over x-node pairs and leading axes)."""
    S = spec.levels[lv]
    Kc = spec.levels[lv + 1].K if lv + 1 < len(spec.levels) else spec.Kc
    F = spec.F
    clead = tuple(d // 2 for d in S.lead)
    half = S.K * LANES // 2
    ncs = int(np.prod(clead)) * Kc * LANES
    g = src[:ncs].view(*clead, Kc * LANES)[..., :half]
    g = g.reshape(*clead, half // F, 1, F).expand(
        *clead, half // F, 2, F).reshape(*clead, 2 * half)
    for ax in range(len(clead)):
        g = g.repeat_interleave(2, dim=ax)
    x += mask.to(x.dtype) * g.reshape(-1)


def coarse_plain(T, bc, xc, partial=None):
    """xc[R*128 + l] = sum_m T[R, m, l] * bc[m]."""
    xc.copy_((T.to(bc.dtype) * bc.view(1, -1, 1)).sum(1).reshape(-1))


class _PlainSteps:
    residual = staticmethod(dia_spmv_plain)
    cheb_apply = staticmethod(cheb_apply_plain)
    restrict = staticmethod(restrict_plain)
    prolong = staticmethod(prolong_plain)
    coarse = staticmethod(coarse_plain)


# ---------------------------------------------------------------------------
# Cycle steps: kernel launches (K2 pieces of csrc/vcycle.cu, K1 residual)
# ---------------------------------------------------------------------------

def _coarse_lead(S: LevelSpec):
    return tuple(d // 2 for d in S.lead)


def _cheb_apply_cuda(offs, cplanes, t, d, x, first, s, c):
    rc = kernels.lib().tpuamg_cheb_apply(
        cplanes.data_ptr(), kernels.storage_flag(cplanes), t.data_ptr(),
        d.data_ptr(), x.data_ptr(), x.numel(), len(offs),
        kernels.int_array(tuple(offs)), int(first), float(s), float(c),
        kernels.stream_ptr())
    kernels.check(rc, "cheb_apply")
    kernels.LAUNCHES["cheb_apply"] += 1


def _restrict_cuda(spec: CycleSpec, lv, t, out):
    S = spec.levels[lv]
    Kc = spec.levels[lv + 1].K if lv + 1 < len(spec.levels) else spec.Kc
    cl = _coarse_lead(S)
    rc = kernels.lib().tpuamg_restrict(
        t.data_ptr(), out.data_ptr(), out.numel(), len(cl),
        kernels.int_array(cl), S.K, Kc, spec.F, kernels.stream_ptr())
    kernels.check(rc, "restrict")
    kernels.LAUNCHES["restrict"] += 1


def _prolong_cuda(spec: CycleSpec, lv, x, mask, src):
    S = spec.levels[lv]
    Kc = spec.levels[lv + 1].K if lv + 1 < len(spec.levels) else spec.Kc
    cl = _coarse_lead(S)
    rc = kernels.lib().tpuamg_prolong(
        x.data_ptr(), mask.data_ptr(), kernels.storage_flag(mask),
        src.data_ptr(), S.n, len(cl), kernels.int_array(cl), S.K, Kc,
        spec.F, kernels.stream_ptr())
    kernels.check(rc, "prolong")
    kernels.LAUNCHES["prolong"] += 1


def _coarse_cuda(T, bc, xc, partial):
    rows_c, nc, _ = T.shape
    nsplit = partial.numel() // nc
    lib = kernels.lib()
    rc = lib.tpuamg_coarse_gemv(T.data_ptr(), kernels.storage_flag(T),
                                bc.data_ptr(), partial.data_ptr(), rows_c,
                                nc, nsplit, kernels.stream_ptr())
    kernels.check(rc, "coarse_gemv")
    kernels.LAUNCHES["coarse_gemv"] += 1
    rc = lib.tpuamg_coarse_reduce(partial.data_ptr(), xc.data_ptr(), nc,
                                  nsplit, kernels.stream_ptr())
    kernels.check(rc, "coarse_reduce")
    kernels.LAUNCHES["coarse_reduce"] += 1


class _CudaSteps:
    residual = staticmethod(dia_spmv)
    cheb_apply = staticmethod(_cheb_apply_cuda)
    restrict = staticmethod(_restrict_cuda)
    prolong = staticmethod(_prolong_cuda)
    coarse = staticmethod(_coarse_cuda)


# ---------------------------------------------------------------------------
# The cycle
# ---------------------------------------------------------------------------

def _coarse_nsplit(rows_c, nc):
    """Column chunks of the coarse GEMV: enough blocks to cover an H100's
    132 SMs about four times over, at least 64 columns per chunk."""
    return max(1, min(-(-528 // max(rows_c, 1)), nc // 64))


def _run_cycle(vc: "FusedVCycle", b0, steps):
    """xs[0] := M b0 (b0 pre-masked), one V or W cycle, as in the JAX
    package's _cycle_machine: per visit, pre-smoothing, residual,
    restriction, the coarser visit(s) or the dense coarse solve,
    prolongation under the level mask, post-smoothing.  A W-cycle's
    second visit of a level starts warm from the first one's x; the coarse
    level is solved once per parent visit."""
    spec = vc.spec
    L = len(spec.levels)
    xs, ts, ds = vc._x, vc._t, vc._d
    bs = [b0] + vc._b

    def cheb(lv, iters):
        S = spec.levels[lv]
        for _ in range(iters):
            for k in range(S.degree):
                steps.residual(S.offsA, vc.A_planes[lv], xs[lv], bs[lv],
                               ts[lv])
                if k == 0:
                    steps.cheb_apply(S.offsC, vc.C_planes[lv], ts[lv],
                                     ds[lv], xs[lv], True, 1.0 / S.theta,
                                     0.0)
                else:
                    a, c = S.coefs[k - 1]
                    steps.cheb_apply(S.offsC, vc.C_planes[lv], ts[lv],
                                     ds[lv], xs[lv], False, a, c)

    def visit(lv, warm):
        S = spec.levels[lv]
        if not warm:
            xs[lv].zero_()
        cheb(lv, S.pre)
        steps.residual(S.offsA, vc.A_planes[lv], xs[lv], bs[lv], ts[lv])
        if lv + 1 < L:
            steps.restrict(spec, lv, ts[lv], bs[lv + 1])
            visit(lv + 1, False)
            if spec.cycle == "w" and 2 ** (lv + 1) <= spec.max_w_work:
                visit(lv + 1, True)
            steps.prolong(spec, lv, xs[lv], vc.M_planes[lv], xs[lv + 1])
        else:
            steps.restrict(spec, lv, ts[lv], vc._bc)
            steps.coarse(vc.T, vc._bc, vc._xc, vc._partial)
            steps.prolong(spec, lv, xs[lv], vc.M_planes[lv], vc._xc)
        cheb(lv, S.post)

    visit(0, False)
    return xs[0]


def vcycle_plain(vc: "FusedVCycle", b):
    """One cycle in plain torch ops on vc's tensors (any device); b must
    be pre-masked float32 of length vc.nflat.  Returns vc's fine x buffer
    (overwritten by the next cycle)."""
    return _run_cycle(vc, b, _PlainSteps)


def vcycle(vc: "FusedVCycle", b):
    """One cycle: the kernels on a CUDA tensor, the plain version on a CPU
    tensor.  b must be pre-masked float32 of length vc.nflat.  Returns
    vc's fine x buffer (overwritten by the next cycle)."""
    if b.device.type == "cpu":
        return _run_cycle(vc, b, _PlainSteps)
    kernels.require(b, "b", dtype=torch.float32, numel=vc.nflat,
                    device=vc.device)
    out = _run_cycle(vc, b, _CudaSteps)
    kernels.LAUNCHES["vcycle"] += 1
    return out


class FusedVCycle:
    """Multilevel cycle preconditioner on the padded grid hierarchy.

    Operates on vectors in the kernel-flat layout (length nflat =
    rows(level 0) * 128); ``matvec`` pre-masks its input.  The work
    vectors of every level are allocated once, here."""

    def __init__(self, spec: CycleSpec, A_planes, C_planes, M_planes, T,
                 mask_flat, level_nnz=(), coarse_n=0):
        self.spec = spec
        self.A_planes = tuple(A_planes)
        self.C_planes = tuple(C_planes)
        self.M_planes = tuple(M_planes)
        self.T = T
        self.mask_flat = mask_flat
        self.level_nnz = tuple(level_nnz)   # real nnz per level
        self.coarse_n = int(coarse_n)       # real coarse dofs
        dev = mask_flat.device
        f32 = dict(dtype=torch.float32, device=dev)
        ns = [S.n for S in spec.levels]
        self._x = [torch.zeros(n, **f32) for n in ns]
        self._t = [torch.zeros(n, **f32) for n in ns]
        self._d = [torch.zeros(n, **f32) for n in ns]
        self._b = [torch.zeros(n, **f32) for n in ns[1:]]
        self._bc = torch.zeros(spec.nc, **f32)
        self._xc = torch.zeros(spec.nc, **f32)
        self._partial = torch.zeros(
            _coarse_nsplit(spec.rows_c, spec.nc) * spec.nc, **f32)
        self._validate()

    def _validate(self):
        """The kernels index these tensors without bounds checks: refuse
        any that do not fit the spec."""
        spec = self.spec

        def need(cond, what):
            if not cond:
                raise ValueError(f"FusedVCycle: {what}")
        need(len(self.A_planes) == len(spec.levels) == len(self.C_planes)
             == len(self.M_planes), "one A, C and M plane set per level")
        need(LANES % (2 * spec.F) == 0, "2F must divide 128")
        for lv, S in enumerate(spec.levels):
            need(all(d % 2 == 0 for d in S.lead),
                 f"level {lv} leading dims {S.lead} must be even")
            Kn = spec.levels[lv + 1].K if lv + 1 < len(spec.levels) \
                else spec.Kc
            need(2 * Kn >= S.K, f"level {lv}: K={S.K} but next K={Kn}")
            for name, t, nd in (("A", self.A_planes[lv], len(S.offsA)),
                                ("C", self.C_planes[lv], len(S.offsC)),
                                ("M", self.M_planes[lv], 1)):
                need(t.is_contiguous() and t.numel() == nd * S.n
                     and t.device == self.device,
                     f"level {lv} {name} planes {tuple(t.shape)} on "
                     f"{t.device}")
        need(tuple(self.T.shape) == (spec.rows_c, spec.nc, LANES)
             and self.T.is_contiguous() and self.T.device == self.device,
             f"T {tuple(self.T.shape)} on {self.T.device}")
        need(self.mask_flat.numel() == self.nflat, "mask length")

    @property
    def device(self):
        return self.mask_flat.device

    @property
    def nflat(self):
        return self.spec.levels[0].n

    def cycle_nnz(self):
        """Stored nonzeros touched per cycle application (one A-read per
        smoother pass + one per residual, every recursive visit, plus the
        dense coarse solve) — the accounting of the JAX package's
        FusedVCycle.cycle_nnz and bench.py."""
        total = 0
        visits = 1
        w = self.spec.cycle == "w"
        cap = self.spec.max_w_work
        for lv, (S, nnz) in enumerate(zip(self.spec.levels,
                                          self.level_nnz)):
            if w and lv and 2 ** lv <= cap:
                visits *= 2
            total += visits * nnz * (S.pre + S.post + 1)
        return total + visits * self.coarse_n * self.coarse_n

    def matvec(self, b):
        bm = b.to(torch.float32) * self.mask_flat
        return vcycle(self, bm).to(b.dtype, copy=True)


def fused_operator(vc: FusedVCycle):
    """The cycle as a krylov-compatible callable."""
    return vc.matvec


# ---------------------------------------------------------------------------
# Host-side setup
# ---------------------------------------------------------------------------

def _coarse_inverse(A: HostCSR, kslots_c, nc, rows_c, sdtype, device):
    """Dense coarse inverse in float32 on the device, embedded into the
    kernel-flat coarse layout (identity on pad dofs) and transposed per
    coarse row block: T[R, m, l] = inv[R*128 + l, m], stored in sdtype."""
    f32 = dict(dtype=torch.float32, device=device)
    ncan = A.shape[0]
    inv_k = torch.eye(nc, **f32)
    if ncan:
        rr, cc, vv = A.to_coo()
        Ad = torch.zeros((ncan, ncan), **f32)
        Ad[torch.as_tensor(rr, device=device),
           torch.as_tensor(cc, device=device)] = torch.as_tensor(
               vv, dtype=torch.float32).to(device)
        ks = torch.as_tensor(kslots_c, device=device)
        inv_k[ks[:, None], ks[None, :]] = torch.linalg.inv(Ad)
    return inv_k.reshape(rows_c, LANES, nc).transpose(1, 2).contiguous() \
        .to(sdtype)


def _to_device(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(device)


def setup_grid_fused(A_host: HostCSR, dims, F=1, mask=None,
                     params: AMGParameters = AMGParameters(),
                     cheb_degree=3, cheb_ratio=8.0, cheb_kind=1,
                     storage_dtype=None, device=None):
    """Build the fused hierarchy.

    A_host in field-major order ([u1-block; u2-block]) on `dims` grid
    points (last axis fastest).  storage_dtype: torch dtype of the A/C/M
    planes and of T (None = float32).  device: None = the CUDA card.
    Returns (FusedVCycle, slots, nflat): slots maps original dof -> kernel
    flat index (RHS scatter + solution gather).

    Raises ValueError when the problem has no level to smooth or the cycle
    is not a V/W cycle with maxit=1."""
    dev = kernels.resolve_device(device)
    dims = tuple(int(d) for d in dims)
    nv = int(np.prod(dims))
    assert A_host.shape[0] == nv * F
    sched = dims_schedule(dims, F, params.max_levels, params.coarse_dof)
    if len(sched) < 2:
        raise ValueError("problem too small to fuse (no levels)")
    if params.cycle_type not in ("v", "w") or params.maxit != 1:
        raise ValueError("fused cycle supports V/W cycles, maxit=1")

    # ---- embed the fine operator into padded canonical order ----------
    dims0 = sched[0]
    n0 = int(np.prod(dims0)) * F
    coords = np.unravel_index(np.arange(nv), dims)
    pnode = np.ravel_multi_index(coords, dims0)
    slots_can = np.empty(nv * F, dtype=np.int64)
    for f in range(F):
        slots_can[f * nv:(f + 1) * nv] = pnode * F + f
    A = _embed_coo(A_host, slots_can, n0)
    mask_np = np.zeros(n0)
    mask_np[slots_can] = 1.0 if mask is None else np.asarray(
        mask, dtype=np.float64)

    sdtype = storage_dtype or torch.float32
    levels_spec = []
    A_planes, C_planes, M_planes = [], [], []
    level_nnz = []
    kernel_slots0 = None
    mask_flat0 = None
    lvl = 0
    while (lvl < len(sched) - 1
           and mask_np.sum() > params.coarse_dof):
        dims_p = sched[lvl]
        K = int(np.ceil(dims_p[-1] * F / LANES))
        rows = int(np.prod(dims_p[:-1])) * K
        nflat = rows * LANES
        kslots = _kernel_slots(dims_p, F, K)
        offsA, dataA = _dia_np(_embed_coo(A, kslots, nflat))
        blockinv = _node_blocks(A, F)

        def apply_binv(r, bi=blockinv, s=F):
            return np.einsum("bij,bj->bi", bi,
                             r.reshape(-1, s)).reshape(-1)
        lmax = _lmax_blockinv(A, apply_binv, mask_np)
        coffs_can, cdata_can = blockinv_dia(blockinv, mask_np)
        Ck = _embed_coo(HostCSR.from_coo(
            *_dia_to_coo(coffs_can, cdata_can, A.shape[0]),
            (A.shape[0], A.shape[0])), kslots, nflat)
        offsC, dataC = _dia_np(Ck)
        theta, coefs = _cheb_coefs(1.1 * lmax, 1.1 * lmax / cheb_ratio,
                                   cheb_degree, cheb_kind)
        levels_spec.append(LevelSpec(
            lead=tuple(dims_p[:-1]), K=K, rows=rows, offsA=offsA,
            offsC=offsC, theta=theta, coefs=coefs,
            degree=int(cheb_degree), pre=int(params.presmooth_iter),
            post=int(params.postsmooth_iter)))
        level_nnz.append(int(A.nnz))
        A_planes.append(_to_device(dataA, sdtype, dev))
        C_planes.append(_to_device(dataC, sdtype, dev))
        mk = np.zeros(nflat)
        mk[kslots] = mask_np
        M_planes.append(_to_device(mk, sdtype, dev))
        if lvl == 0:
            kernel_slots0 = kslots[slots_can]
            mask_flat0 = _to_device(mk, torch.float32, dev)
        A, mask_np, _ = _grid_coarse(A, mask_np, dims_p, F)
        # re-pad the lane axis to the schedule's next padded dims
        cdims_raw = tuple(d // 2 for d in dims_p[:-1]) + (dims_p[-1] // 2,)
        if lvl + 1 < len(sched) and sched[lvl + 1][-1] > cdims_raw[-1]:
            A, mask_np = _pad_lane_axis(A, mask_np, cdims_raw,
                                        sched[lvl + 1][-1], F)
        lvl += 1

    L = lvl
    if L == 0:
        raise ValueError("no fused levels built")
    dims_c = sched[L] if L < len(sched) else sched[-1]
    Kc = int(np.ceil(dims_c[-1] * F / LANES))
    rows_c = int(np.prod(dims_c[:-1])) * Kc
    nc = rows_c * LANES
    spec = CycleSpec(levels=tuple(levels_spec), F=int(F), Kc=Kc,
                     rows_c=rows_c, nc=nc, cycle=params.cycle_type,
                     max_w_work=params.max_w_work)
    T = _coarse_inverse(A, _kernel_slots(dims_c, F, Kc), nc, rows_c,
                        sdtype, dev)
    vc = FusedVCycle(spec, A_planes, C_planes, M_planes, T, mask_flat0,
                     level_nnz=level_nnz, coarse_n=A.shape[0])
    return vc, kernel_slots0, vc.nflat


def grid_system_fused(A_host: HostCSR, slots, nflat, dtype=torch.float32,
                      device=None) -> KernelDIA:
    """Outer (CG) operator in the kernel-flat layout, run by kernel K1."""
    r, c, v = A_host.to_coo()
    Ak = HostCSR.from_coo(slots[r], slots[c], v, (nflat, nflat))
    return KernelDIA.from_host(Ak, dtype=dtype, device=device)
