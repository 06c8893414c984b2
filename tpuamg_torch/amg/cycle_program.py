"""The fused cycle compiled once into a flat program of op records.

Counterpart of the JAX package's ``amg/grid_fused.py:_cycle_machine``,
which unrolls one whole V/W cycle into straight-line code inside one TPU
program.  Here a ``FusedVCycle`` is walked once, in the order of
``grid_fused._run_cycle`` (pre-smoothing, residual, restriction, the
coarser visit(s) or the dense coarse solve, prolongation, post-smoothing;
a W-cycle's second, warm visit of level lv+1 while 2^(lv+1) <=
max_w_work), into a list of ops:

  CHEB_STEP(lv, first, s, c)
                 one Chebyshev step, its t-pass and C-apply together:
                 t = b - A x;  d = s C t (first) or s d + c C t;
                 x_dst = x_src + d.  A cold step (the first of a cold
                 visit) takes x = 0: t = b, x_dst = d.
  RESID_RESTRICT(lv)
                 b[lv+1] (or bc below the last level) = R (b - A x)
  PROLONG(lv)    x[lv] += M[lv] * P x[lv+1] (or xc)
  COARSE_GEMV, COARSE_REDUCE
                 xc = T bc, as per-split partials and their sum in a
                 fixed order
  ZERO(lv)       x = 0, for a cold visit with no pre-smoothing

Level 0's b is the caller's right-hand side.  The JAX cycle machine runs
the t-pass and the C-apply of a step in one block loop, the C-apply one
block behind; on the card the C-apply of row i needs t only inside row
i's node block of F rows (C is the nodal block inverse), which one warp
holds, so a step is one pass with no barrier inside.  The pass reads x
at the neighbouring offsets of A while it writes x + d, so every level
has two x buffers, and each step reads one and writes the other; the
compiler tracks which one holds the level's x (``src``/``dst``/``nsrc``
of each op) and ends every cold visit in buffer 0, so the cycle leaves z
in vc's fine x buffer.  The residual before a restriction is computed
inside the restriction, which reads each fine entry once.

The program is what the two persistent kernels run, through the device
interpreter they share (csrc/cycle_program.cuh): K5 (csrc/
pcg_persistent.cu) inside its PCG iteration loop, with r as level 0's
right-hand side, and the one-launch cycle (csrc/cycle_persistent.cu,
``grid_fused.vcycle``), with the caller's b.  A ``FusedVCycle`` owns one
program (``vc.program()``), whichever kernel runs it.  The ops are an
int32 table (``OP_WORDS`` per op) and the levels an int64 table of
pointers, sizes and offsets (``LEVEL_WORDS`` per level), both in device
memory, copied into each block's shared memory when a kernel starts.

Every op runs on all blocks in grid-stride loops and ends at a grid-wide
barrier, except the cycle's last op: K5's next r.z reads z[i] only in
the thread that wrote it, and the one-launch cycle ends there.  Small
levels are grid ops too: on the H100, one block walking a level alone
between block barriers made the K5 chunk slower at every threshold tried
(PERF.md, section 6).

``run_program_plain`` executes the same records, buffers included, with
the plain torch steps of ``grid_fused`` (any device); it equals
``vcycle_plain`` bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..kernels import MAX_DIAGS

ZERO, CHEB_STEP, RESID_RESTRICT, PROLONG, COARSE_GEMV, COARSE_REDUCE = \
    range(6)
OP_NAMES = ("ZERO", "CHEB_STEP", "RESID_RESTRICT", "PROLONG", "COARSE_GEMV",
            "COARSE_REDUCE")

# The table layouts; csrc/cycle_program.cuh has the same numbers, and
# grid_fused._check_layout checks them against the built library.  An op is 4 int32:
# kind | level << 8 | flags << 16, s (float32 bits), c (float32 bits), 0.
OP_WORDS = 4
F_FIRST, F_COLD, F_SRC, F_DST, F_NSRC, F_NO_BARRIER = 1, 2, 4, 8, 16, 32
COARSE_LEVEL = 255      # the level field of the coarse ops
(L_A, L_C, L_M, L_X0, L_X1, L_D, L_B, L_NEXT_B, L_NEXT_X0, L_NEXT_X1, L_N,
 L_N_NEXT, L_K, L_KC, L_F, L_NLEAD, L_LEAD) = range(17)
L_NDA = L_LEAD + 3
L_NDC = L_NDA + 1
L_OFFA = L_NDC + 1
L_OFFC = L_OFFA + MAX_DIAGS
LEVEL_WORDS = L_OFFC + MAX_DIAGS
WARP = 32


@dataclass(frozen=True)
class Op:
    kind: int
    level: int = -1          # -1 for the coarse ops
    first: bool = False
    s: float = 0.0           # the exact host coefficients; the device
    c: float = 0.0           # table holds their float32 roundings
    cold: bool = False       # CHEB_STEP: x = 0 on entry
    src: int = 0             # the x buffer read (PROLONG: updated)
    dst: int = 0             # the x buffer written (CHEB_STEP, ZERO)
    nsrc: int = 0            # PROLONG: the coarser level's x buffer
    barrier: bool = True     # a grid barrier after the op

    def __repr__(self):
        extra = ""
        if self.kind == CHEB_STEP:
            extra = (f", first={self.first}, cold={self.cold}, "
                     f"x{self.src}->x{self.dst}")
        return f"{OP_NAMES[self.kind]}({self.level}{extra})"

    def record(self):
        """The op's 4 int32 words."""
        flags = (F_FIRST * self.first + F_NO_BARRIER * (not self.barrier)
                 + F_COLD * self.cold + F_SRC * self.src + F_DST * self.dst
                 + F_NSRC * self.nsrc)
        lv = COARSE_LEVEL if self.level < 0 else self.level
        sc = np.array([self.s, self.c], np.float32).view(np.int32)
        return (self.kind | lv << 8 | flags << 16, int(sc[0]), int(sc[1]),
                0)


def compile_ops(spec):
    """The op list of one cycle of ``spec`` (a grid_fused.CycleSpec), each
    op with its x buffers; the last op has no barrier after it."""
    L = len(spec.levels)
    raw = []
    cur = [0] * L            # the buffer that holds each level's x

    def cheb(lv, iters, cold):
        S = spec.levels[lv]
        nsteps = S.degree * (S.pre + S.post)
        for _ in range(iters):
            for k in range(S.degree):
                if k == 0:
                    first, s, c = True, 1.0 / S.theta, 0.0
                else:
                    (s, c), first = S.coefs[k - 1], False
                # a cold visit starts in the buffer that makes its last
                # step land in buffer 0
                dst = (nsteps - 1) % 2 if cold else 1 - cur[lv]
                raw.append(Op(CHEB_STEP, lv, first, s, c, cold=cold,
                              src=cur[lv], dst=dst))
                cur[lv] = dst
                cold = False

    def visit(lv, warm):
        S = spec.levels[lv]
        cold = not warm
        if cold and S.pre == 0:
            cur[lv] = S.degree * S.post % 2
            raw.append(Op(ZERO, lv, dst=cur[lv]))
            cold = False
        cheb(lv, S.pre, cold)
        raw.append(Op(RESID_RESTRICT, lv, src=cur[lv]))
        if lv + 1 < L:
            visit(lv + 1, False)
            if spec.cycle == "w" and 2 ** (lv + 1) <= spec.max_w_work:
                visit(lv + 1, True)
            nsrc = cur[lv + 1]
        else:
            raw.append(Op(COARSE_GEMV))
            raw.append(Op(COARSE_REDUCE))
            nsrc = 0
        raw.append(Op(PROLONG, lv, src=cur[lv], nsrc=nsrc))
        cheb(lv, S.post, False)

    visit(0, False)
    assert cur[0] == 0, "the cycle must leave z in the fine x buffer"
    # the kernel's next r.z reads z[i] in the thread that wrote it
    return raw[:-1] + [replace(raw[-1], barrier=False)]


def _check_nodal_c(vc):
    """The fused step takes C t inside node blocks of F rows held by one
    warp: F must divide 32, and every C entry that crosses a node block
    must be zero (it is for the nodal block inverse that
    setup_grid_fused builds)."""
    F = vc.spec.F
    if WARP % F:
        raise ValueError(f"CycleProgram: F={F} does not divide {WARP}")
    for lv, S in enumerate(vc.spec.levels):
        i = torch.arange(S.n, device=vc.device) % F
        for d, o in enumerate(S.offsC):
            out = ((i + o) < 0) | ((i + o) >= F)
            if bool((vc.C_planes[lv][d][out] != 0).any()):
                raise ValueError(f"CycleProgram: level {lv} C offset {o} "
                                 f"crosses node blocks of {F} rows")


def _check_storage(vc):
    """The kernels read every level's A, C and M planes and T as one
    storage type."""
    types = {t.dtype for t in (*vc.A_planes, *vc.C_planes, *vc.M_planes,
                               vc.T)}
    if len(types) != 1:
        raise TypeError(f"CycleProgram: the planes and T must share one "
                        f"storage type, not {sorted(map(str, types))}")


class CycleProgram:
    """A FusedVCycle's cycle as op records plus its level descriptor
    table, both as host numpy arrays and as tensors on the cycle's device
    (built once, by ``vc.program()``).  The pointers are those of vc's own
    buffers and of the program's second x buffer per level, so the
    program is valid for as long as vc lives."""

    def __init__(self, vc):
        spec = vc.spec
        _check_nodal_c(vc)
        _check_storage(vc)
        self.ops = compile_ops(spec)
        L = len(spec.levels)
        # each level's second x buffer; buffer 0 is vc's own
        self.x_alt = [torch.zeros_like(x) for x in vc._x]
        # the coarse GEMV's column splits: 16 columns or fewer each while
        # nc <= 1024 (a split is then a couple of rounds of memory
        # latency), at most 64 splits, so longer ones above that: 66
        # columns at the bench path's nc = 4224, where the GEMV and its
        # reduce stream T (35.7 MB in bf16) at 0.53 of their bytes bound
        # on the H100, as near as a level-0 step comes (PERF.md, section 6)
        self.nsplit = max(1, min(64, -(-spec.nc // 16)))
        self.partial = torch.zeros(self.nsplit * spec.nc,
                                   dtype=torch.float32, device=vc.device)
        lv_tab = np.zeros((L, LEVEL_WORDS), np.int64)
        for lv, S in enumerate(spec.levels):
            last = lv + 1 == L
            cl = tuple(d // 2 for d in S.lead)
            if len(S.offsA) > MAX_DIAGS or len(S.offsC) > MAX_DIAGS:
                raise ValueError(f"level {lv}: more than {MAX_DIAGS} "
                                 f"diagonals")
            if not 1 <= len(cl) <= 3:
                raise ValueError(f"level {lv}: {len(cl)} leading axes")
            row = lv_tab[lv]
            row[L_A] = vc.A_planes[lv].data_ptr()
            row[L_C] = vc.C_planes[lv].data_ptr()
            row[L_M] = vc.M_planes[lv].data_ptr()
            row[L_X0] = vc._x[lv].data_ptr()
            row[L_X1] = self.x_alt[lv].data_ptr()
            row[L_D] = vc._d[lv].data_ptr()
            row[L_B] = 0 if lv == 0 else vc._b[lv - 1].data_ptr()
            nxt_b = vc._bc if last else vc._b[lv]
            row[L_NEXT_B] = nxt_b.data_ptr()
            row[L_NEXT_X0] = (vc._xc if last else vc._x[lv + 1]).data_ptr()
            row[L_NEXT_X1] = (vc._xc if last
                              else self.x_alt[lv + 1]).data_ptr()
            row[L_N] = S.n
            row[L_N_NEXT] = nxt_b.numel()
            row[L_K] = S.K
            row[L_KC] = spec.Kc if last else spec.levels[lv + 1].K
            row[L_F] = spec.F
            row[L_NLEAD] = len(cl)
            row[L_LEAD:L_LEAD + len(cl)] = cl
            row[L_NDA] = len(S.offsA)
            row[L_NDC] = len(S.offsC)
            row[L_OFFA:L_OFFA + len(S.offsA)] = S.offsA
            row[L_OFFC:L_OFFC + len(S.offsC)] = S.offsC
        op_tab = np.array([op.record() for op in self.ops], np.int32)
        self.level_table = lv_tab
        self.op_table = op_tab.reshape(len(self.ops), OP_WORDS)
        dev = vc.device
        self.levels_dev = torch.from_numpy(lv_tab).to(dev)
        self.ops_dev = torch.from_numpy(self.op_table).to(dev)

    def __len__(self):
        return len(self.ops)

    def shared_bytes(self):
        """The shared memory the kernel stages the two tables into."""
        return self.level_table.nbytes + self.op_table.nbytes

    def grid_barriers(self):
        return sum(op.barrier for op in self.ops)

    def counts(self):
        """{op name: number of ops}."""
        out = {}
        for op in self.ops:
            out[OP_NAMES[op.kind]] = out.get(OP_NAMES[op.kind], 0) + 1
        return out


def run_program_plain(prog: CycleProgram, vc, b0):
    """xs[0] := M b0 by executing prog's ops, with their x buffers, with
    the plain torch steps of grid_fused (b0 pre-masked float32 of length
    vc.nflat).  Returns vc's fine x buffer.  A step writes x_src + d into
    its dst buffer (a copy, then the in-place update of the plain
    C-apply); the plain coarse solve is one dense product, so COARSE_GEMV
    computes xc and COARSE_REDUCE has nothing left to do."""
    from .grid_fused import _PlainSteps as steps
    spec = vc.spec
    L = len(spec.levels)
    xs = [(x0, x1) for x0, x1 in zip(vc._x, prog.x_alt)]
    ts, ds = vc._t, vc._d
    bs = [b0] + vc._b
    for op in prog.ops:
        lv = op.level
        if op.kind == ZERO:
            xs[lv][op.dst].zero_()
        elif op.kind == CHEB_STEP:
            S = spec.levels[lv]
            x = xs[lv][op.dst]
            if op.cold:
                x.zero_()
            elif op.dst != op.src:
                x.copy_(xs[lv][op.src])
            steps.residual(S.offsA, vc.A_planes[lv], x, bs[lv], ts[lv])
            steps.cheb_apply(S.offsC, vc.C_planes[lv], ts[lv], ds[lv], x,
                             op.first, op.s, op.c)
        elif op.kind == RESID_RESTRICT:
            S = spec.levels[lv]
            steps.residual(S.offsA, vc.A_planes[lv], xs[lv][op.src],
                           bs[lv], ts[lv])
            steps.restrict(spec, lv, ts[lv],
                           vc._bc if lv + 1 == L else bs[lv + 1])
        elif op.kind == PROLONG:
            src = vc._xc if lv + 1 == L else xs[lv + 1][op.nsrc]
            steps.prolong(spec, lv, xs[lv][op.src], vc.M_planes[lv], src)
        elif op.kind == COARSE_GEMV:
            steps.coarse(vc.T, vc._bc, vc._xc, vc._partial)
    return xs[0][0]
