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

A Chebyshev smoother sweep of the unfused hierarchy (the JAX package's
``sparse/dia_pallas.py:_cheb_kernel``) is a short program of the same
records, which kernel K3 (csrc/cheb_persistent.cu) runs through the
sweep form of the interpreter: iters x degree CHEB_STEP ops and, for
``smooth_residual``, one

  RESIDUAL(row)  r = b - A x_src, into the row's next-b word
  CHEB_APPLY(row, first, s, c)
                 the C-apply half of a step whose RESIDUAL wrote t, for
                 an F that does not divide 32 (such a step is two ops)

on one level whose table rows name the call's vectors by code
(``SweepProgram``, ``compile_sweep_ops``).  ``run_sweep_plain`` executes
them in plain torch; it equals ``sparse.dia_kernels.cheb_sweep_plain``
bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..kernels import MAX_DIAGS

(ZERO, CHEB_STEP, RESID_RESTRICT, PROLONG, COARSE_GEMV, COARSE_REDUCE,
 RESIDUAL, CHEB_APPLY) = range(8)
OP_NAMES = ("ZERO", "CHEB_STEP", "RESID_RESTRICT", "PROLONG", "COARSE_GEMV",
            "COARSE_REDUCE", "RESIDUAL", "CHEB_APPLY")

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
        if self.kind in (CHEB_STEP, CHEB_APPLY):
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


def _check_node_blocks(planes, offs, F, what):
    """Every C entry that crosses a node block of F rows must be zero (it
    is for the nodal block inverse, sparse.dia_kernels.blockinv_dia)."""
    i = torch.arange(planes.shape[-1], device=planes.device) % F
    for d, o in enumerate(offs):
        out = ((i + o) < 0) | ((i + o) >= F)
        if bool((planes[d][out] != 0).any()):
            raise ValueError(f"{what}: C offset {o} crosses node blocks of "
                             f"{F} rows")


def _check_nodal_c(vc):
    """The fused step takes C t inside node blocks of F rows held by one
    warp: F must divide 32, and every C entry that crosses a node block
    must be zero (it is for the nodal block inverse that
    setup_grid_fused builds)."""
    F = vc.spec.F
    if WARP % F:
        raise ValueError(f"CycleProgram: F={F} does not divide {WARP}")
    for lv, S in enumerate(vc.spec.levels):
        _check_node_blocks(vc.C_planes[lv], S.offsC, F,
                           f"CycleProgram: level {lv}")


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


# ---------------------------------------------------------------------------
# A smoother sweep as a program of the same interpreter (kernel K3)
# ---------------------------------------------------------------------------

# The call's vectors, which a sweep's level table names by the code
# -(1 + v) in a pointer word; csrc/cheb_persistent.cu binds them per call
CALL_X, CALL_B, CALL_X_OUT, CALL_R = range(4)
_CALLS = {"x": CALL_X, "b": CALL_B, "out": CALL_X_OUT, "r": CALL_R}

# A sweep's level rows: one level seen four ways, which differ only in
# what their x0, x1 and next-b words name: the caller's x, the returned x
# ("out") and r, the smoother's second x buffer ("alt") and its t
ROW_FIRST_ALT, ROW_FIRST_OUT, ROW_STEP, ROW_RESID = range(4)
SWEEP_ROWS = (("x", "alt", "t"),      # a first step that writes alt
              ("out", "x", "t"),      # a first step that writes out
              ("out", "alt", "t"),    # every later step
              ("out", "x", "r"))      # the residual of out (or of x)


def call_code(v):
    """The level-table word that names the call's vector v."""
    return -(1 + v)


def compile_sweep_ops(theta, coefs, degree, iters, want_r, split=False):
    """The op list of one smoother application: iters x degree steps
    (CHEB_STEP, or RESIDUAL into t + CHEB_APPLY when split), then with
    want_r one RESIDUAL into r.  The first step reads the caller's x; the
    steps alternate between the returned x and the second buffer so that
    the last one writes the returned x.  A grid barrier after every op but
    the last; empty when there is nothing to run."""
    nsteps = degree * iters
    ops = []
    prev = 0
    for j in range(nsteps):
        k = j % degree
        if k == 0:
            first, s, c = True, 1.0 / theta, 0.0
        else:
            (s, c), first = coefs[k - 1], False
        dst = (nsteps - 1 - j) % 2           # 0: the returned x, 1: alt
        if j == 0:
            row, src = (ROW_FIRST_OUT, 1) if dst == 0 else (ROW_FIRST_ALT, 0)
        else:
            row, src = ROW_STEP, prev
        if split:
            ops.append(Op(RESIDUAL, row, src=src))
            ops.append(Op(CHEB_APPLY, row, first, s, c, src=src, dst=dst))
        else:
            ops.append(Op(CHEB_STEP, row, first, s, c, src=src, dst=dst))
        prev = dst
    if want_r:
        ops.append(Op(RESIDUAL, ROW_RESID, src=0 if nsteps else 1))
    if not ops:
        return []
    return ops[:-1] + [replace(ops[-1], barrier=False)]


class SweepProgram:
    """One Chebyshev smoother's sweeps as op records over a level table of
    four rows (SWEEP_ROWS), built once per smoother: the rows hold the
    planes, offsets, n, F and the smoother's own d, second x and t, and
    name the call's vectors by code.  The op tables, one per (iters,
    want_r), are built at their first use.  An F that divides 32 runs a
    step as one CHEB_STEP (t shared by warp shuffles inside a node block);
    any other F as RESIDUAL + CHEB_APPLY."""

    def __init__(self, offsA, planesA, offsC, planesC, n, F, theta, coefs,
                 degree):
        n, F = int(n), int(F)
        if planesA.dtype != planesC.dtype:
            raise TypeError(f"SweepProgram: the A and C planes must share "
                            f"one storage type, not {planesA.dtype} and "
                            f"{planesC.dtype}")
        if len(offsA) > MAX_DIAGS or len(offsC) > MAX_DIAGS:
            raise ValueError(f"SweepProgram: more than {MAX_DIAGS} "
                             f"diagonals")
        if len(coefs) != degree - 1:
            raise ValueError(f"{len(coefs)} coefficient pairs for degree "
                             f"{degree}")
        if F < 1 or n % F:
            raise ValueError(f"SweepProgram: {n} rows are not node blocks "
                             f"of F={F}")
        _check_node_blocks(planesC, offsC, F, "SweepProgram")
        self.offsA, self.planesA = tuple(offsA), planesA
        self.offsC, self.planesC = tuple(offsC), planesC
        self.n, self.F = n, F
        self.theta, self.coefs, self.degree = theta, tuple(coefs), degree
        self.split = WARP % F != 0
        dev = planesA.device
        self.device = dev
        self.x_alt = torch.zeros(n, dtype=torch.float32, device=dev)
        self.d = torch.zeros(n, dtype=torch.float32, device=dev)
        self.t = (torch.zeros(n, dtype=torch.float32, device=dev)
                  if self.split else None)
        own = {"alt": self.x_alt, "t": self.t}

        def word(name):
            if name in _CALLS:
                return call_code(_CALLS[name])
            return 0 if own[name] is None else own[name].data_ptr()
        tab = np.zeros((len(SWEEP_ROWS), LEVEL_WORDS), np.int64)
        for row, (x0, x1, nb) in zip(tab, SWEEP_ROWS):
            row[L_A] = planesA.data_ptr()
            row[L_C] = planesC.data_ptr()
            row[L_X0], row[L_X1], row[L_NEXT_B] = word(x0), word(x1), word(nb)
            row[L_D] = self.d.data_ptr()
            row[L_B] = word("b")
            row[L_N] = n
            row[L_F] = F
            row[L_NDA] = len(offsA)
            row[L_NDC] = len(offsC)
            row[L_OFFA:L_OFFA + len(offsA)] = offsA
            row[L_OFFC:L_OFFC + len(offsC)] = offsC
        self.level_table = tab
        self.levels_dev = torch.from_numpy(tab).to(dev)
        self._compiled = {}

    def _program(self, iters, want_r):
        """(ops, their int32 (nops, OP_WORDS) table on the device), built
        at the first use of (iters, want_r)."""
        key = (int(iters), bool(want_r))
        if key not in self._compiled:
            ops = compile_sweep_ops(self.theta, self.coefs, self.degree,
                                    *key, self.split)
            tab = np.array([op.record() for op in ops], np.int32).reshape(
                len(ops), OP_WORDS)
            self._compiled[key] = (ops, torch.from_numpy(tab).to(
                self.device))
        return self._compiled[key]

    def ops(self, iters, want_r):
        """The op list of one application."""
        return self._program(iters, want_r)[0]

    def op_table(self, iters, want_r):
        """The op table of one application on the device."""
        return self._program(iters, want_r)[1]

    def shared_bytes(self, iters, want_r):
        """The shared memory the kernel stages the two tables into."""
        return self.level_table.nbytes + self.op_table(
            iters, want_r).numel() * 4


def run_sweep_plain(prog: SweepProgram, x, b, iters=1, want_r=False):
    """One application by executing prog's ops, with their buffers, in
    plain torch (any device): (x_new, b - A x_new or None), x unchanged.
    Equals sparse.dia_kernels.cheb_sweep_plain bit for bit."""
    from ..sparse.dia_kernels import dia_spmv_plain
    ops = prog.ops(iters, want_r)
    out = torch.empty_like(x) if iters * prog.degree else x.clone()
    r = torch.empty_like(x) if want_r else None
    bufs = {"x": x, "out": out, "alt": prog.x_alt, "t": prog.t, "r": r}
    d = prog.d
    for op in ops:
        x0, x1, nb = (bufs[name] for name in SWEEP_ROWS[op.level])
        xs = (x0, x1)[op.src]
        if op.kind == RESIDUAL:
            dia_spmv_plain(prog.offsA, prog.planesA, xs, b, out=nb)
            continue
        if op.kind == CHEB_STEP:
            t = dia_spmv_plain(prog.offsA, prog.planesA, xs, b)
        else:                                   # CHEB_APPLY: t is nb
            t = nb
        ct = dia_spmv_plain(prog.offsC, prog.planesC, t)
        d.copy_(op.s * ct if op.first else op.s * d + op.c * ct)
        torch.add(xs, d, out=(x0, x1)[op.dst])
    return out, r
