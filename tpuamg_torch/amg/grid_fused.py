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

The cycle (``vcycle``) on a CUDA tensor is ONE persistent cooperative
launch of kernel K2 (csrc/cycle_persistent.cu): the cycle is compiled
once into an op program (amg/cycle_program.py, ``vc.program()``), which
the kernel runs through the device interpreter it shares with K5
(csrc/cycle_program.cuh).  On a CPU tensor ``vcycle`` runs the program's
plain interpreter, ``run_program_plain``, which equals ``vcycle_plain``
(the host sequence of the plain torch steps defined here) bit for bit.
``vcycle_sequenced`` keeps the earlier design for comparison on the card
(no route takes it): the same host sequence with one hand-written launch
per step, K1 (csrc/dia.cu) for the t-passes and residuals and K2's pieces
(csrc/vcycle.cu) for the Chebyshev C-apply, restriction, prolongation and
coarse GEMV, 78 launches per V-cycle at the bench path's 4 levels.

Around the cycle: ``FusedPCG`` / ``pcg_fused`` run PCG in chunks of
iterations with no host read inside a chunk.  On the card a chunk is ONE
persistent cooperative launch of kernel K5 (csrc/pcg_persistent.cu),
which runs the PCG body and the same op program, inside the kernel;
``pcg_chunk_plain`` is its plain version.  ``pcg_chunk_sequenced`` keeps
the earlier design (three csrc/pcg.cu launches per iteration around
``vcycle_sequenced``) for comparison on the card; no route takes it.
``setup_grid_fused(reference=True)`` also returns the f64
``MGPreconditioner`` of the same padded hierarchy, the step-by-step
reference of both.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..config import AMGParameters
from ..kernels import LANES
from ..sparse import HostCSR
from ..sparse.dia_kernels import (_CHEB_ARGS, KernelDIA, _cheb_coefs,
                                  blockinv_dia, dia_spmv, dia_spmv_plain)
from ..sparse.dia import DIA
from .cycle_program import CycleProgram, run_program_plain
from .grid import _grid_coarse, _lmax_blockinv, _node_blocks
from .hierarchy import MGPreconditioner
from .structured import BlockChebyshevSmoother


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
    """One cycle z = M b: one launch of the persistent cycle kernel on a
    CUDA tensor, its plain version (``run_program_plain`` of the same op
    program) on a CPU tensor.  b must be pre-masked float32 of length
    vc.nflat.  Returns vc's fine x buffer (overwritten by the next
    cycle)."""
    if b.device.type == "cpu":
        return run_program_plain(vc.program(), vc, b)
    out = _cycle_persistent(vc, b)
    kernels.LAUNCHES["vcycle"] += 1
    return out


def vcycle_sequenced(vc: "FusedVCycle", b):
    """The earlier design of the cycle, kept to time it beside the
    one-launch kernel on the card: one hand-written launch per step (K2's
    pieces of csrc/vcycle.cu, K1's residual form), sequenced from the
    host.  CUDA tensors only; no route calls it.  Same contract as
    vcycle."""
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
        self._program = None
        self._validate()

    def program(self) -> CycleProgram:
        """The cycle's op program (compiled once), which the one-launch
        cycle, K5 and run_program_plain all run."""
        if self._program is None:
            self._program = CycleProgram(self)
        return self._program

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


class _PadGridLevel:
    """Reference level whose transfers re-pad the lane axis to the next
    level's even-padded dims, mirroring the fused cycle's layout chain.
    Built only by setup_grid_fused(reference=True)."""

    def __init__(self, A, smoother, mask, dims, F, cdims_p):
        self.A = A
        self.smoother = smoother
        self.mask = mask
        self.dims = tuple(dims)
        self.F = F
        self.cdims_p = tuple(cdims_p)
        self.nc = int(np.prod(self.cdims_p)) * F

    def restrict(self, r):
        g = (r * self.mask).reshape(self.dims + (self.F,))
        for ax in range(len(self.dims)):
            d2 = self.dims[ax] // 2
            shape = g.shape[:ax] + (d2, 2) + g.shape[ax + 1:]
            g = g.reshape(shape).sum(dim=ax + 1)
        pad = self.cdims_p[-1] - g.shape[-2]
        if pad:
            shape = list(g.shape)
            shape[-2] = pad
            g = torch.cat([g, g.new_zeros(shape)], dim=-2)
        return g.reshape(-1)

    def prolong(self, ec):
        g = ec.reshape(self.cdims_p + (self.F,))
        cd_last = self.dims[-1] // 2
        if self.cdims_p[-1] > cd_last:
            g = g.narrow(len(self.dims) - 1, 0, cd_last)
        for ax in range(len(self.dims)):
            g = g.repeat_interleave(2, dim=ax)
        return g.reshape(-1) * self.mask


# ---------------------------------------------------------------------------
# Host-side setup
# ---------------------------------------------------------------------------

def _coarse_inverse(A: HostCSR, kslots_c, nc, rows_c, sdtype, device,
                    inv_can=None):
    """Dense coarse inverse in float32 on the device, embedded into the
    kernel-flat coarse layout (identity on pad dofs) and transposed per
    coarse row block: T[R, m, l] = inv[R*128 + l, m], stored in sdtype.
    inv_can: a host inverse to embed instead of the device LU."""
    f32 = dict(dtype=torch.float32, device=device)
    ncan = A.shape[0]
    inv_k = torch.eye(nc, **f32)
    if inv_can is not None:
        ks = torch.as_tensor(kslots_c, device=device)
        inv_k[ks[:, None], ks[None, :]] = torch.as_tensor(
            inv_can, dtype=torch.float32).to(device)
    elif ncan:
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
                     storage_dtype=None, device=None, reference=False):
    """Build the fused hierarchy.

    A_host in field-major order ([u1-block; u2-block]) on `dims` grid
    points (last axis fastest).  storage_dtype: torch dtype of the A/C/M
    planes and of T (None = float32).  device: None = the CUDA card.
    Returns (FusedVCycle, slots, nflat): slots maps original dof -> kernel
    flat index (RHS scatter + solution gather).

    reference=True also returns the f64 ``MGPreconditioner`` of the same
    padded canonical hierarchy and the canonical slots: (vc, slots, nflat,
    ref, slots_can).  T then embeds the host f64 coarse inverse that ref
    uses, not the device LU.

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
    ref_levels = []
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
        if reference:
            f64 = torch.float64
            ref_levels.append(_PadGridLevel(
                DIA.from_host(A, dtype=f64, device=dev),
                BlockChebyshevSmoother(
                    _to_device(blockinv, f64, dev),
                    _to_device(mask_np, f64, dev), 1.1 * lmax,
                    1.1 * lmax / cheb_ratio, cheb_degree, kind=cheb_kind),
                _to_device(mask_np, f64, dev), dims_p, F, sched[lvl + 1]))
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
    inv_can = None
    if reference:
        inv_can = np.linalg.inv(A.toarray()) if A.shape[0] else \
            np.zeros((0, 0))
    T = _coarse_inverse(A, _kernel_slots(dims_c, F, Kc), nc, rows_c,
                        sdtype, dev, inv_can)
    vc = FusedVCycle(spec, A_planes, C_planes, M_planes, T, mask_flat0,
                     level_nnz=level_nnz, coarse_n=A.shape[0])
    if reference:
        ref = MGPreconditioner(
            tuple(ref_levels), _to_device(inv_can, torch.float64, dev),
            cycle=params.cycle_type, maxit=1,
            presmooth=params.presmooth_iter,
            postsmooth=params.postsmooth_iter,
            max_w_work=params.max_w_work)
        return vc, kernel_slots0, vc.nflat, ref, slots_can
    return vc, kernel_slots0, vc.nflat


def grid_system_fused(A_host: HostCSR, slots, nflat, dtype=torch.float32,
                      device=None) -> KernelDIA:
    """Outer (CG) operator in the kernel-flat layout, run by kernel K1."""
    r, c, v = A_host.to_coo()
    Ak = HostCSR.from_coo(slots[r], slots[c], v, (nflat, nflat))
    return KernelDIA.from_host(Ak, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Chunked fused PCG: kernel K5 (csrc/pcg_persistent.cu) and its plain version
# ---------------------------------------------------------------------------
#
# A chunk is `chunk` complete PCG iterations with no host read inside:
#   rz = r.z;  beta = rz / rz_prev (0 while rz_prev <= 0);
#   p = z + beta p;  q = Q p;  alpha = rz / (p.q + tiny);
#   x += alpha p;  r -= alpha q;  z = M r  (the whole cycle, r its rhs)
# with x0 = 0 and z0 = M(b mask) computed before the first chunk.  The
# stats rows follow the JAX package's layout: row it = (alpha, beta,
# sqrt|rz|, ||r||, ||x||, 0...) with row it's beta and sqrt|rz| those of
# the NEXT r.z (the last row's from one more r.z after the loop), and
# row chunk = (rz_T, rz_last, iterations run, why), which carries rz across
# chunks and says where the chunk stopped: why = 0 ran it whole, 1 met the
# stop test, 2 found sqrt|rz| non-finite.  A chunk given a stop test (type
# 1/2/3 and threshold, _stop_args) stops at the first iteration that meets
# it, with x that iteration's iterate.

_TINY32 = 1e-30
STATS_LANES = LANES
MAX_PARTS = 512     # per-block partial sums of a pcg.cu reduction


def _stop_args(stop):
    """(type, threshold, tol) of a chunk's stop test; None = none (type 0,
    the whole chunk).  The threshold is tol*||b|| for type 1, tol*res0 for
    type 2, unused for type 3 (||r|| <= tol max(||x||, 1e-300))."""
    if stop is None:
        return 0, 0.0, 0.0
    kind, thr, tol = stop
    if kind not in (1, 2, 3):
        raise ValueError(f"stop type {kind} is not 1, 2 or 3")
    return int(kind), float(thr), float(tol)


def _stopped(kind, thr, tol, row):
    """The chunk's exit test on one stats row (float32 values, compared
    in float64 as the persistent kernel compares them): 0 go on, 1 met,
    2 non-finite."""
    res = float(row[2])
    if not np.isfinite(res):
        return 2
    if kind == 2:
        return int(res <= thr)
    rt = float(row[3])
    if kind == 1:
        return int(rt <= thr)
    return int(rt <= tol * max(float(row[4]), 1e-300))


def pcg_chunk_plain(fp: "FusedPCG", x, r, p, z, rz_prev, chunk, stop=None,
                    cycle=None):
    """One chunk in torch ops on the kernel-flat layout (any device).
    x and r are updated in place; returns (x, r, p, z, stats).  stop:
    (type, threshold, tol) ends the chunk at the crossing (_stop_args),
    None runs it whole.  cycle(vc, r) -> z is the preconditioner,
    vcycle_plain by default."""
    vc = fp.vc
    Q = fp.Q
    kind, thr, tol = _stop_args(stop)
    cycle = vcycle_plain if cycle is None else cycle
    stats = torch.zeros((chunk + 1, STATS_LANES), dtype=torch.float32,
                        device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    rz_last = rz_prev.reshape(())
    ran, why = chunk, 0
    for it in range(chunk + 1):
        rz = torch.dot(r, z)
        beta = torch.where(rz_last > 0, rz / (rz_last + _TINY32), zero)
        if it:
            stats[it - 1, 1] = beta
            stats[it - 1, 2] = torch.sqrt(rz.abs())
            if kind:
                why = _stopped(kind, thr, tol, stats[it - 1, :5].tolist())
                if why:
                    ran = it
                    break
        if it == chunk:
            break
        p = z + beta * p
        q = dia_spmv_plain(Q.offsets, Q.planes, p)
        alpha = rz / (torch.dot(p, q) + _TINY32)
        x.add_(alpha * p)
        r.sub_(alpha * q)
        stats[it, 0] = alpha
        stats[it, 3] = torch.linalg.vector_norm(r)
        stats[it, 4] = torch.linalg.vector_norm(x)
        z = cycle(vc, r)
        rz_last = rz
    stats[chunk, 0] = rz
    stats[chunk, 1] = rz_last
    stats[chunk, 2] = ran
    stats[chunk, 3] = why
    return x, r, p, z, stats


class _PCGWork:
    """Device scratch of a chunk on the card: two p buffers (p is never
    updated in place: blocks read it at neighbouring offsets), q, the
    per-block partial sums (pcg.cu's three sets of MAX_PARTS, or the
    persistent kernel's four of `grid`), the rz history and the stats
    rows."""

    def __init__(self, n, chunk, device, grid=0):
        f32 = dict(dtype=torch.float32, device=device)
        self.p = (torch.zeros(n, **f32), torch.zeros(n, **f32))
        self.q = torch.zeros(n, **f32)
        self.rz_parts = torch.zeros(MAX_PARTS, **f32)
        self.pq_parts = torch.zeros(MAX_PARTS, **f32)
        self.norm_parts = torch.zeros(2 * MAX_PARTS, **f32)
        self.parts = torch.zeros(4 * max(grid, 1), **f32)
        self.rzbuf = torch.zeros(chunk + 1, **f32)
        self.stats = torch.zeros((chunk + 1, STATS_LANES), **f32)
        self.chunk = chunk
        self.grid = grid


def _chunk_inputs(fp: "FusedPCG", x, r, p, z, rz_prev, chunk, grid=0):
    """Check the chunk's tensors, (re)make the runner's scratch, and move
    z into the cycle's fine x buffer and p into a p buffer.  Returns
    (work, z buffer, index of the p buffer holding p)."""
    vc = fp.vc
    n = vc.nflat
    dev = vc.device
    for name, t in (("x", x), ("r", r), ("p", p), ("z", z)):
        kernels.require(t, name, dtype=torch.float32, numel=n, device=dev)
    kernels.require(rz_prev, "rz_prev", dtype=torch.float32, numel=1,
                    device=dev)
    kernels.require(fp.Q.planes, "Q planes", dtype=torch.float32,
                    numel=len(fp.Q.offsets) * n, device=dev)
    w = fp._work
    if w is None or w.chunk < chunk or w.grid < grid:
        w = fp._work = _PCGWork(n, chunk, dev, grid)
    zb = vc._x[0]                    # the cycle writes z here
    if z.data_ptr() != zb.data_ptr():
        zb.copy_(z)
    if p.data_ptr() == w.p[1].data_ptr():
        return w, zb, 1
    if p.data_ptr() != w.p[0].data_ptr():
        w.p[0].copy_(p)
    return w, zb, 0


def pcg_chunk_sequenced(fp: "FusedPCG", x, r, p, z, rz_prev, chunk):
    """The earlier design of K5, kept to time it beside the persistent
    kernel on the card: per iteration three csrc/pcg.cu launches (pcg_rz,
    pcg_pq, pcg_xr) and the host-sequenced cycle (vcycle_sequenced), then
    pcg_rz and pcg_finish.  CUDA tensors only; no route calls it.  Same
    contract as pcg_chunk."""
    vc = fp.vc
    Q = fp.Q
    n = vc.nflat
    w, zb, cur = _chunk_inputs(fp, x, r, p, z, rz_prev, chunk)
    w.rzbuf[:1].copy_(rz_prev.reshape(1))
    w.stats.zero_()
    lib = kernels.lib()
    offs = kernels.int_array(tuple(Q.offsets))
    stream = kernels.stream_ptr()

    def rz_pass():
        kernels.check(lib.tpuamg_pcg_rz(r.data_ptr(), zb.data_ptr(),
                                        w.rz_parts.data_ptr(), n, stream),
                      "pcg_rz")
        kernels.LAUNCHES["pcg_rz"] += 1

    for it in range(chunk):
        p_old, p_new = w.p[cur], w.p[1 - cur]
        rz_pass()
        kernels.check(lib.tpuamg_pcg_pq(
            Q.planes.data_ptr(), len(Q.offsets), offs, zb.data_ptr(),
            p_old.data_ptr(), p_new.data_ptr(), w.q.data_ptr(), n,
            w.rz_parts.data_ptr(), w.pq_parts.data_ptr(),
            w.norm_parts.data_ptr(), w.rzbuf.data_ptr(), it,
            w.stats.data_ptr(), stream), "pcg_pq")
        kernels.LAUNCHES["pcg_pq"] += 1
        kernels.check(lib.tpuamg_pcg_xr(
            x.data_ptr(), r.data_ptr(), p_new.data_ptr(), w.q.data_ptr(),
            n, w.pq_parts.data_ptr(), w.rzbuf.data_ptr(), it,
            w.norm_parts.data_ptr(), w.stats.data_ptr(), stream), "pcg_xr")
        kernels.LAUNCHES["pcg_xr"] += 1
        vcycle_sequenced(vc, r)
        cur = 1 - cur
    rz_pass()
    kernels.check(lib.tpuamg_pcg_finish(
        w.rz_parts.data_ptr(), w.norm_parts.data_ptr(), n,
        w.rzbuf.data_ptr(), chunk, w.stats.data_ptr(), stream),
        "pcg_finish")
    kernels.LAUNCHES["pcg_finish"] += 1
    kernels.LAUNCHES["pcg_chunk_sequenced"] += 1
    return x, r, w.p[cur], zb, w.stats


# the host argument vector of tpuamg_pcg_persistent, in its order (thr
# and tol: the bits of float64 values)
_PERSISTENT_ARGS = ("levels", "nlevels", "ops", "nops", "Q_planes", "x", "r",
                    "p0", "p1", "q", "z", "n", "parts", "rz_prev", "stats",
                    "chunk", "T", "bc", "xc", "partial", "rows_c", "nc",
                    "nsplit", "stop", "thr", "tol")


def _f64_bits(v):
    return struct.unpack("<q", struct.pack("<d", float(v)))[0]


# the host argument vector of tpuamg_cycle_persistent, in its order
_CYCLE_ARGS = ("levels", "nlevels", "ops", "nops", "b", "T", "bc", "xc",
               "partial", "rows_c", "nc", "nsplit")
_KERNEL_ARGS = {"pcg": _PERSISTENT_ARGS, "cycle": _CYCLE_ARGS,
                "cheb": _CHEB_ARGS}


def _check_layout(kernel):
    """The library's table layouts are amg/cycle_program.py's; kernel is
    "pcg" (K5), "cycle" (the one-launch cycle) or "cheb" (K3's sweep)."""
    from . import cycle_program as cp
    lay = (ctypes.c_int * 4)()
    getattr(kernels.lib(), f"tpuamg_{kernel}_persistent_layout")(lay)
    want = (cp.LEVEL_WORDS, cp.OP_WORDS, len(_KERNEL_ARGS[kernel]),
            kernels.MAX_DIAGS)
    if tuple(lay) != want:
        raise RuntimeError(f"{kernel}_persistent: library layout "
                           f"{tuple(lay)} != host layout {want}")


# The persistent launches: one block (of the kernels' 512 threads) per
# SM.  On the H100, 1024 threads per block or more resident blocks made
# the 8-iteration K5 chunk slower (PERF.md, section 6).
BLOCKS_PER_SM = 1


@functools.lru_cache(maxsize=None)
def _persistent_occupancy(kernel, planes_bf16, smem, device_index):
    """(resident blocks per SM, SMs) of a persistent kernel ("pcg",
    "cycle" or "cheb"), once per plane type, staged table size and
    device."""
    _check_layout(kernel)
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        kernels.check(getattr(
            kernels.lib(), f"tpuamg_{kernel}_persistent_occupancy")(
                int(planes_bf16), int(smem), out),
            f"{kernel}_persistent occupancy")
    return int(out[0]), int(out[1])


def _grid_of(kernel, planes, smem):
    """(grid, resident blocks per SM, SMs) of a persistent kernel reading
    planes of `planes`' type on its device, with smem bytes of tables:
    SMs x min(occupancy, BLOCKS_PER_SM)."""
    dev = planes.device.index if planes.device.index is not None \
        else torch.cuda.current_device()
    per_sm, sms = _persistent_occupancy(
        kernel, kernels.storage_flag(planes), smem, dev)
    return sms * min(per_sm, BLOCKS_PER_SM), per_sm, sms


def persistent_grid(fp: "FusedPCG"):
    """(grid, resident blocks per SM, SMs) of fp's persistent launch."""
    return _grid_of("pcg", fp.vc.A_planes[0], fp.program().shared_bytes())


def cycle_grid(vc: "FusedVCycle"):
    """(grid, resident blocks per SM, SMs) of vc's one-launch cycle."""
    return _grid_of("cycle", vc.A_planes[0], vc.program().shared_bytes())


def _cycle_persistent(vc: "FusedVCycle", b, _grid=None, _ops=None):
    """One cycle as one cooperative launch; returns vc's fine x buffer.
    _grid overrides the grid (a card test asks for one too large to be
    co-resident); _ops, an int32 (nops, OP_WORDS) table on the device,
    runs other records of the same program (chip_smoke.py times single
    ops with it)."""
    kernels.require(b, "b", dtype=torch.float32, numel=vc.nflat,
                    device=vc.device)
    prog = vc.program()
    for t in (vc._x[0], prog.x_alt[0], vc._d[0]):
        if kernels.overlaps(b, t):
            raise ValueError("vcycle: b overlaps a level-0 buffer that the "
                             "cycle writes")
    ops = prog.ops_dev if _ops is None else _ops
    kernels.require(ops, "ops", dtype=torch.int32, device=vc.device)
    spec = vc.spec
    smem = prog.level_table.nbytes + ops.numel() * ops.element_size()
    grid, per_sm, sms = _grid_of("cycle", vc.A_planes[0], smem)
    grid = grid if _grid is None else int(_grid)
    vals = dict(
        levels=prog.levels_dev.data_ptr(), nlevels=len(spec.levels),
        ops=ops.data_ptr(), nops=ops.shape[0], b=b.data_ptr(),
        T=vc.T.data_ptr(), bc=vc._bc.data_ptr(), xc=vc._xc.data_ptr(),
        partial=prog.partial.data_ptr(), rows_c=spec.rows_c, nc=spec.nc,
        nsplit=prog.nsplit)
    args = (ctypes.c_longlong * len(_CYCLE_ARGS))(
        *(int(vals[k]) for k in _CYCLE_ARGS))
    rc = kernels.lib().tpuamg_cycle_persistent(
        args, len(_CYCLE_ARGS), kernels.storage_flag(vc.A_planes[0]), grid,
        smem, kernels.stream_ptr())
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel cycle_persistent failed: cudaError {rc} on a grid "
            f"of {grid} blocks x 512 threads ({sms} SMs x {per_sm} "
            f"resident blocks per SM)")
    kernels.LAUNCHES["cycle_persistent"] += 1
    return vc._x[0]


def _pcg_chunk_persistent(fp: "FusedPCG", x, r, p, z, rz_prev, chunk,
                          stop=None, _grid=None):
    """One chunk as one cooperative launch; _grid overrides the grid (a
    card test asks for one too large to be co-resident)."""
    kind, thr, tol = _stop_args(stop)
    vc = fp.vc
    Q = fp.Q
    spec = vc.spec
    grid, per_sm, sms = persistent_grid(fp)
    grid = grid if _grid is None else int(_grid)
    w, zb, cur = _chunk_inputs(fp, x, r, p, z, rz_prev, chunk, grid)
    if kernels.overlaps(rz_prev, w.stats):    # the kernel zeroes stats
        rz_prev = rz_prev.clone()
    prog = fp.program()
    vals = dict(
        levels=prog.levels_dev.data_ptr(), nlevels=len(spec.levels),
        ops=prog.ops_dev.data_ptr(), nops=len(prog),
        Q_planes=Q.planes.data_ptr(), x=x.data_ptr(), r=r.data_ptr(),
        p0=w.p[cur].data_ptr(), p1=w.p[1 - cur].data_ptr(),
        q=w.q.data_ptr(), z=zb.data_ptr(), n=vc.nflat,
        parts=w.parts.data_ptr(), rz_prev=rz_prev.data_ptr(),
        stats=w.stats.data_ptr(), chunk=chunk, T=vc.T.data_ptr(),
        bc=vc._bc.data_ptr(), xc=vc._xc.data_ptr(),
        partial=prog.partial.data_ptr(), rows_c=spec.rows_c, nc=spec.nc,
        nsplit=prog.nsplit, stop=kind, thr=_f64_bits(thr),
        tol=_f64_bits(tol))
    args = (ctypes.c_longlong * len(_PERSISTENT_ARGS))(
        *(int(vals[k]) for k in _PERSISTENT_ARGS))
    rc = kernels.lib().tpuamg_pcg_persistent(
        args, len(_PERSISTENT_ARGS), kernels.int_array(tuple(Q.offsets)),
        len(Q.offsets), kernels.storage_flag(vc.A_planes[0]), grid,
        prog.shared_bytes(), kernels.stream_ptr())
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel pcg_persistent failed: cudaError {rc} on a grid "
            f"of {grid} blocks x 512 threads ({sms} SMs x {per_sm} "
            f"resident blocks per SM)")
    kernels.LAUNCHES["pcg_chunk"] += 1
    return x, r, w.p[(cur + chunk) % 2], zb, w.stats[:chunk + 1]


def pcg_chunk(fp: "FusedPCG", x, r, p, z, rz_prev, chunk, stop=None):
    """One chunk: the persistent kernel K5 on CUDA tensors (one launch,
    the cycle inside), the plain version on CPU tensors.  x and r are
    updated in place; p and z may come back in the runner's own buffers
    (valid until its next chunk).  stop: (type, threshold, tol) ends the
    chunk at the crossing (_stop_args), None runs it whole.  Returns (x,
    r, p, z, stats (chunk + 1, 128) float32 on the device)."""
    if x.device.type == "cpu":
        return pcg_chunk_plain(fp, x, r, p, z, rz_prev, chunk, stop)
    return _pcg_chunk_persistent(fp, x, r, p, z, rz_prev, chunk, stop)


class FusedPCG:
    """Chunked PCG runner on the fused hierarchy: `chunk` iterations per
    ``run_chunk`` with no host read inside.

    Wraps a FusedVCycle (the preconditioner) and the outer operator Q as
    a KernelDIA over the same kernel-flat layout, whose planes stay
    float32: the CG matvec defines the true residual and cannot take
    storage rounding, unlike the preconditioner."""

    def __init__(self, vc: FusedVCycle, Q: KernelDIA):
        if Q.planes.dtype != torch.float32:
            raise TypeError("FusedPCG: the outer operator must be float32")
        if Q.shape[0] != vc.nflat or Q.planes.device != vc.device:
            raise ValueError("FusedPCG: Q does not match the cycle's "
                             "layout or device")
        self.vc = vc
        self.Q = Q
        self._work = None

    def program(self) -> CycleProgram:
        """The cycle's op program: vc's own (vc.program())."""
        return self.vc.program()

    def run_chunk(self, x, r, p, z, rz_prev, chunk, stop=None):
        return pcg_chunk(self, x, r, p, z, rz_prev, int(chunk), stop)


def pcg_fused(fp: FusedPCG, b, tol=1e-8, maxiter=500, chunk=32,
              stop_type=2, callback=None):
    """PCG with the chunked runner; mirrors krylov.cg.pcg's host loop, its
    diagnostics contract (CGResult) and stop types.  b and the returned x
    are in the kernel-flat layout (length vc.nflat).  The host reads the
    stats rows once per chunk.  Each chunk is given the solve's stop test
    and stops at its crossing (or at a non-finite residual); the host cuts
    the history at the count the chunk reports, and x is the crossing
    iterate."""
    from ..krylov.cg import CGResult
    vc = fp.vc
    b = b.to(torch.float32)
    bm = b * vc.mask_flat
    maxiter = int(maxiter)
    chunk = max(1, min(int(chunk), maxiter))
    z = vcycle(vc, bm)                     # z0 = M r0, r0 = b (x0 = 0)
    r = bm.clone()
    x = torch.zeros_like(r)
    p = torch.zeros_like(r)
    init = torch.stack([torch.dot(bm, z), torch.linalg.vector_norm(bm),
                        torch.linalg.vector_norm(b)]).double().cpu().numpy()
    rz, rnorm0 = float(init[0]), float(init[1])
    res0 = float(np.sqrt(max(rz, 0.0)))
    res_hist = [res0]
    true_hist = [rnorm0]
    norm_b = float(init[2]) if stop_type == 1 else 0.0
    alphas, betas = [], []
    k = executed = 0
    reads = 1
    if stop_type == 1:
        converged = rnorm0 <= tol * norm_b or norm_b == 0.0
    else:
        converged = res0 == 0.0
    rz_prev = torch.full((1,), -1.0, dtype=torch.float32, device=b.device)
    kind = stop_type if stop_type in (1, 3) else 2
    stop = (kind, tol * (norm_b if kind == 1 else res0), tol)

    while not converged and k < maxiter:
        n_run = min(chunk, maxiter - k)
        x, r, p, z, stats = fp.run_chunk(x, r, p, z, rz_prev, n_run, stop)
        o = stats.double().cpu().numpy()   # the one host read per chunk
        reads += 1
        rz_prev = stats[n_run, 1:2].clone()
        ran, why = int(o[n_run, 2]), int(o[n_run, 3])
        o = o[:n_run, :5]
        # the chunk's own count: the kernel's test, not a second one
        take, converged, stopped = ran, why == 1, why != 0
        executed += ran
        alphas.extend(o[:take, 0].tolist())
        betas.extend(o[:take, 1].tolist())
        res_hist.extend(o[:take, 2].tolist())
        true_hist.extend(o[:take, 3].tolist())
        k += take
        if stopped and not converged:
            break
    res = np.asarray(res_hist)
    true = np.asarray(true_hist)
    if callback is not None:
        for i in range(1, k + 1):
            callback(i, None, true[i])
    return CGResult(x=x, niters=k, converged=bool(converged),
                    residuals=res, true_residuals=true,
                    alphas=np.asarray(alphas), betas=np.asarray(betas),
                    executed=executed, host_reads=reads)


def setup_grid_fused_pcg(A_host: HostCSR, dims, F=1, mask=None,
                         params: AMGParameters = AMGParameters(),
                         cheb_degree=3, cheb_ratio=8.0, cheb_kind=1,
                         storage_dtype=None, device=None):
    """FusedVCycle + the float32 outer operator -> (FusedPCG, slots,
    nflat).  Raises ValueError where setup_grid_fused does."""
    vc, slots, nflat = setup_grid_fused(
        A_host, dims, F=F, mask=mask, params=params,
        cheb_degree=cheb_degree, cheb_ratio=cheb_ratio,
        cheb_kind=cheb_kind, storage_dtype=storage_dtype, device=device)
    Q = grid_system_fused(A_host, slots, nflat, dtype=torch.float32,
                          device=vc.device)
    return FusedPCG(vc, Q), slots, nflat
