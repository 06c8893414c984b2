"""K3 as one launch per smoother application (csrc/cheb_persistent.cu):
its sweep program, the plain interpreter of that program, and the host
side of the launch.

* run_sweep_plain(SweepProgram) equals cheb_sweep_plain bit for bit:
  degree 1-4, iters 0-2, with and without r, f32 and bf16 planes, node
  blocks of F = 1, 2 and 3 (3 does not divide a warp: each step is two
  ops, RESIDUAL into t and CHEB_APPLY).
* The same program against the JAX FusedChebSmoother in interpret mode,
  at tests/test_torch_grid_path.py's limit (2e-5), for F = 2 and 3; each
  JAX run is made once, in a module fixture.
* The op lists: steps, buffers, barriers.
* The launch's argument vector, grid and shared-memory size, its
  refusals and its launch count, with the library replaced by a recorder
  (no card here); two calls on one smoother return fresh tensors.
* The programs refuse a C that crosses node blocks and mixed storage.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from tpuamg_torch import kernels
from tpuamg_torch.amg import cycle_program as cp
from tpuamg_torch.amg import grid_fused
from tpuamg_torch.sparse import dia_kernels
from tpuamg_torch.sparse.dia_kernels import (FusedChebSmoother,
                                             _cheb_coefs, blockinv_dia,
                                             cheb_sweep, cheb_sweep_plain)

LMAX, LMIN = 1.8, 0.22


def _inputs(F, storage=torch.float32, nodes=234, seed=0, mask=True):
    """A diagonally dominant random DIA over far and near offsets, the
    masked inverse of random F x F node blocks as C (blockinv_dia, as the
    grid path builds it), and x, b; n = nodes * F rows, from numpy."""
    rng = np.random.default_rng(seed)
    n = nodes * F
    offsA = (-26 * F - 1, -26 * F, -F - 1, -1, 0, 1, F + 1, 26 * F,
             26 * F + 1)
    planes = rng.standard_normal((len(offsA), n)) * 0.1
    planes[offsA.index(0)] = 2.0 + rng.random(n)
    blockinv = np.linalg.inv(rng.standard_normal((nodes, F, F)) * 0.1
                             + 2 * np.eye(F))
    m = np.ones(n)
    if mask:
        m[-F - 1:] = 0.0          # ghost rows, as the grid path's mask
    offsC, cdata = blockinv_dia(blockinv, m)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)

    def planes_of(p):
        return torch.as_tensor(p, dtype=torch.float32).to(storage)
    return (offsA, planes_of(planes), tuple(offsC), planes_of(cdata), x, b,
            planes, blockinv)


def _smoother(F, degree=3, storage=torch.float32, **kw):
    offsA, pA, offsC, pC, x, b, _, _ = _inputs(F, storage, **kw)
    sm = FusedChebSmoother(offsA, pA, offsC, pC, x.shape[0], LMAX, LMIN,
                           degree)
    return sm, x, b


# ---------------------------------------------------------------------------
# The plain interpreter of the program against the plain sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 2, 3])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sweep_program_is_cheb_sweep_plain_bitwise(degree, F, storage):
    sm, x, b = _smoother(F, degree, storage)
    prog = sm.program()
    assert prog.F == F and prog.split == (F == 3)
    x0 = x.clone()
    for iters in (0, 1, 2):
        for want_r in (False, True):
            xp, rp = cheb_sweep_plain(sm.offsA, sm.planesA, sm.offsC,
                                      sm.planesC, x, b, sm.theta, sm.coefs,
                                      degree, iters, want_r)
            xs, rs = cp.run_sweep_plain(prog, x, b, iters, want_r)
            assert torch.equal(xs, xp), (iters, want_r)
            assert (rs is None) == (not want_r)
            assert rs is None or torch.equal(rs, rp), iters
            assert xs.data_ptr() != x.data_ptr()
    assert torch.equal(x, x0)


# ---------------------------------------------------------------------------
# Against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

JAX_CASES = {"F2-degree4": (2, 4), "F3-degree3": (3, 3)}


@pytest.fixture(scope="module")
def jax_sweeps():
    """{case: (inputs, {(iters, want_r): (x, r)} of the JAX
    FusedChebSmoother in interpret mode)}: one smooth at iters 1 and 2
    and one smooth_residual per case."""
    from tpuamg.sparse import HostCSR as JHostCSR
    from tpuamg.sparse.dia import DIA as JDIA
    from tpuamg.sparse.dia_pallas import FusedChebSmoother as JFused
    out = {}
    for case, (F, degree) in JAX_CASES.items():
        inp = _inputs(F, seed=4)
        offsA, _, offsC, _, x, b, planes, _ = inp
        n = x.shape[0]
        rows, cols, vals = [], [], []
        for d, o in enumerate(offsA):
            r = np.arange(max(0, -o), min(n, n - o))
            rows.append(r)
            cols.append(r + o)
            vals.append(planes[d, r])
        Asp = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                    np.concatenate(cols))),
                            shape=(n, n))
        JA = JDIA.from_host(JHostCSR(Asp.indptr, Asp.indices, Asp.data,
                                     Asp.shape))
        JC = JDIA(offsC, jnp.asarray(inp[3].numpy()), (n, n))
        jsm = JFused.build(JA, JC, LMAX, LMIN, degree=degree,
                           interpret=True)
        xj, bj = jnp.asarray(x.numpy()), jnp.asarray(b.numpy())
        ref = {(it, False): (np.asarray(jsm.smooth(None, xj, bj, it)), None)
               for it in (1, 2)}
        xr, rr = jsm.smooth_residual(None, xj, bj, 1)
        ref[(1, True)] = (np.asarray(xr), np.asarray(rr))
        out[case] = (inp, degree, ref)
    return out


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_sweep_program_matches_jax_kernel(jax_sweeps, case):
    """The one-launch kernel's program, run plain, against _cheb_kernel:
    f32 sums in another order, at test_torch_grid_path.py's 2e-5."""
    (offsA, pA, offsC, pC, x, b, _, _), degree, ref = jax_sweeps[case]
    sm = FusedChebSmoother(offsA, pA, offsC, pC, x.shape[0], LMAX, LMIN,
                           degree)
    for (iters, want_r), (xj, rj) in ref.items():
        xs, rs = cp.run_sweep_plain(sm.program(), x, b, iters, want_r)
        assert _rel(xs, xj) < 2e-5, (iters, want_r)
        if want_r:
            assert _rel(rs, rj) < 2e-5


# ---------------------------------------------------------------------------
# The op lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("degree,iters", [(1, 1), (3, 1), (3, 2), (4, 1),
                                          (2, 0)])
def test_sweep_ops_and_buffers(degree, iters, split):
    """iters x degree steps (two ops each when split), fFirst at each
    iteration's first step, then r; the first step reads the caller's x,
    each later one the buffer the one before wrote, the last writes the
    returned x; a barrier after every op but the last."""
    theta, coefs = _cheb_coefs(LMAX, LMIN, degree)
    for want_r in (False, True):
        ops = cp.compile_sweep_ops(theta, coefs, degree, iters, want_r,
                                   split)
        nsteps = degree * iters
        assert len(ops) == nsteps * (1 + split) + want_r
        assert [op.barrier for op in ops] == [True] * (len(ops) - 1) + [
            False] * bool(ops)
        steps = [op for op in ops if op.kind in (cp.CHEB_STEP,
                                                 cp.CHEB_APPLY)]
        kind = cp.CHEB_APPLY if split else cp.CHEB_STEP
        assert [op.kind for op in steps] == [kind] * nsteps
        assert [op.first for op in steps] == [j % degree == 0
                                              for j in range(nsteps)]
        names = [(cp.SWEEP_ROWS[op.level][op.src],
                  cp.SWEEP_ROWS[op.level][op.dst]) for op in steps]
        if nsteps:
            assert names[0][0] == "x" and names[-1][1] == "out"
        for (_, dst), (src, _) in zip(names, names[1:]):
            assert src == dst != "x"
        assert all(src != dst for src, dst in names)
        if split:        # each step's t pass reads what its C-apply reads
            for t_op, c_op in zip(ops[0::2], ops[1::2]):
                assert t_op.kind == cp.RESIDUAL and t_op.src == c_op.src
                assert t_op.level == c_op.level != cp.ROW_RESID
        if want_r:
            last = ops[-1]
            assert last.kind == cp.RESIDUAL and last.level == cp.ROW_RESID
            assert cp.SWEEP_ROWS[last.level][last.src] == (
                "out" if nsteps else "x")
            assert cp.SWEEP_ROWS[last.level][2] == "r"


def test_sweep_level_table():
    """Four rows of one level: the same planes, offsets, n, F and d; the
    x0, x1 and next-b words name the call's vectors by code or hold the
    smoother's own second x and t; b is the call's in every row."""
    sm, x, b = _smoother(3, storage=torch.bfloat16)
    prog = sm.program()
    tab = prog.level_table
    assert tab.shape == (4, cp.LEVEL_WORDS)
    own = {"alt": prog.x_alt.data_ptr(), "t": prog.t.data_ptr()}
    for row, names in zip(tab, cp.SWEEP_ROWS):
        assert row[cp.L_A] == sm.planesA.data_ptr()
        assert row[cp.L_C] == sm.planesC.data_ptr()
        assert row[cp.L_D] == prog.d.data_ptr()
        assert row[cp.L_B] == cp.call_code(cp.CALL_B) == -2
        assert (row[cp.L_N], row[cp.L_F]) == (sm.n, 3)
        assert row[cp.L_NDA] == len(sm.offsA) and row[cp.L_NDC] == 5
        assert tuple(row[cp.L_OFFA:cp.L_OFFA + len(sm.offsA)]) == sm.offsA
        assert tuple(row[cp.L_OFFC:cp.L_OFFC + 5]) == sm.offsC
        words = row[[cp.L_X0, cp.L_X1, cp.L_NEXT_B]]
        for w, name in zip(words, names):
            assert w == own.get(name, cp.call_code(
                {"x": cp.CALL_X, "out": cp.CALL_X_OUT, "r": cp.CALL_R}.get(
                    name, 0)))
    assert torch.equal(prog.levels_dev, torch.from_numpy(tab))
    assert _smoother(2)[0].program().t is None      # no split, no t


# ---------------------------------------------------------------------------
# The launch, with the library replaced by a recorder
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the kernel library: records tpuamg_cheb_persistent's
    arguments and returns rc."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def tpuamg_cheb_persistent(self, args, nargs, flag, grid, smem, stream):
        self.calls.append((list(args), nargs, flag, grid, smem, stream))
        return self.rc


@pytest.fixture
def recorder(monkeypatch):
    """The library replaced by a _Recorder; an H100's 132 SMs at one
    resident block each."""
    rec = _Recorder()
    monkeypatch.setattr(kernels, "_lib", rec)
    monkeypatch.setattr(kernels, "require", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda: 7)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(grid_fused, "_persistent_occupancy",
                        lambda kernel, flag, smem, dev: (1, 132))
    kernels.reset_launches()
    return rec


@pytest.mark.parametrize("F", [2, 3])
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_cheb_launch_arguments(recorder, storage, F):
    """One launch per application with the program's tables, the caller's
    x and b and the returned x and r, in _CHEB_ARGS order (the order
    test_table_layouts_match_cuda_source holds against the CUDA source)."""
    sm, x, b = _smoother(F, storage=storage)
    prog = sm.program()
    for iters, want_r in ((1, True), (2, False)):
        kernels.reset_launches()
        out, r = dia_kernels._cheb_persistent(prog, x, b, iters, want_r)
        assert dict(kernels.LAUNCHES) == {"cheb_sweep": 1}
        args, nargs, flag, grid, smem, stream = recorder.calls[-1]
        got = dict(zip(dia_kernels._CHEB_ARGS, args))
        table = prog.op_table(iters, want_r)
        assert nargs == len(dia_kernels._CHEB_ARGS) == len(args)
        assert got == dict(
            levels=prog.levels_dev.data_ptr(), nlevels=4,
            ops=table.data_ptr(), nops=len(prog.ops(iters, want_r)),
            x=x.data_ptr(), b=b.data_ptr(), x_out=out.data_ptr(),
            r=0 if r is None else r.data_ptr())
        assert (r is None) == (not want_r)
        assert flag == kernels.storage_flag(sm.planesA)
        assert (grid, smem, stream) == (132, prog.level_table.nbytes
                                        + table.numel() * 4, 7)
        assert table.shape == (got["nops"], cp.OP_WORDS)
        assert np.array_equal(table.numpy(), np.array(
            [op.record() for op in prog.ops(iters, want_r)], np.int32))
    # the tables are built once per smoother and per (iters, want_r)
    assert sm.program() is prog
    assert prog.op_table(1, True) is prog.op_table(1, True)


def test_two_calls_return_fresh_tensors(recorder):
    """The returned x and r are allocated per call: they alias neither
    each other, the other call's, the caller's x and b, nor a buffer the
    smoother owns (NL-AMLI keeps z alive across the next call at the same
    level)."""
    sm, x, b = _smoother(2)
    prog = sm.program()
    outs = [dia_kernels._cheb_persistent(prog, x, b, 1, True)
            for _ in range(2)]
    outs += [(dia_kernels._cheb_persistent(prog, x, b, 1, False)[0],)]
    tensors = [t for o in outs for t in o] + [x, b]
    owned = [prog.x_alt, prog.d]
    for i, t in enumerate(tensors):
        for u in tensors[i + 1:] + owned:
            assert not kernels.overlaps(t, u)
    assert [c[0][6] for c in recorder.calls] == [o[0].data_ptr()
                                                 for o in outs]


def test_cheb_launch_refused_raises(recorder):
    """A refused cooperative launch raises with the grid and the
    occupancy; nothing falls back and nothing is counted."""
    sm, x, b = _smoother(2)
    recorder.rc = 720          # cudaErrorCooperativeLaunchTooLarge
    with pytest.raises(RuntimeError, match="resident blocks per SM"):
        dia_kernels._cheb_persistent(sm.program(), x, b, 1, True, _grid=133)
    assert recorder.calls[-1][3] == 133
    assert not kernels.LAUNCHES["cheb_sweep"]


def test_empty_program_launches_nothing(recorder):
    """No step and no r: nothing runs, and x_new is a copy of x, as the
    plain version gives; no step with r: one launch of the residual."""
    sm, x, b = _smoother(2)
    out, r = dia_kernels._cheb_persistent(sm.program(), x, b, 0, False)
    assert r is None and torch.equal(out, x)
    assert out.data_ptr() != x.data_ptr() and not recorder.calls
    out, r = dia_kernels._cheb_persistent(sm.program(), x, b, 0, True)
    assert torch.equal(out, x) and len(recorder.calls) == 1
    assert [op.kind for op in sm.program().ops(0, True)] == [cp.RESIDUAL]


def test_cpu_tensors_run_the_plain_sweep():
    """On CPU tensors the smoother and cheb_sweep run cheb_sweep_plain
    and launch nothing; F is the node size C's offsets imply."""
    sm, x, b = _smoother(2, degree=4)
    assert sm.F == 2
    kernels.reset_launches()
    xs, r = sm.smooth_residual(None, x, b, 2)
    xp, rp = cheb_sweep_plain(sm.offsA, sm.planesA, sm.offsC, sm.planesC,
                              x, b, sm.theta, sm.coefs, 4, 2, True)
    assert torch.equal(xs, xp) and torch.equal(r, rp)
    assert torch.equal(sm.smooth(None, x, b, 2), xp)
    xc, rc = cheb_sweep(sm.offsA, sm.planesA, sm.offsC, sm.planesC, x, b,
                        sm.theta, sm.coefs, 4, 2, True)
    assert torch.equal(xc, xp) and torch.equal(rc, rp)
    assert not any(kernels.LAUNCHES.values())
    assert _smoother(3)[0].F == 3 and _smoother(1)[0].F == 1


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_program_refuses_c_across_node_blocks():
    """C is the nodal block inverse: an entry that crosses a node block
    is refused when the program is built (the warp-shuffle step and the
    split one both rely on it)."""
    sm, x, b = _smoother(2, mask=False)
    planes = sm.planesC
    d = sm.offsC.index(1)
    keep = planes[d, 1].clone()
    planes[d, 1] = 0.5            # row 1 (f = 1) reading row 2: a new node
    with pytest.raises(ValueError, match="crosses node blocks"):
        sm.program()
    planes[d, 1] = keep
    sm.program()
    # the same C over node blocks of 1 row crosses them everywhere
    args = (sm.offsA, sm.planesA, sm.offsC, planes, sm.n)
    cheb = (sm.theta, sm.coefs, sm.degree)
    with pytest.raises(ValueError, match="crosses node blocks"):
        cp.SweepProgram(*args, 1, *cheb)
    assert sm.n % 5
    with pytest.raises(ValueError, match="not node blocks of F=5"):
        cp.SweepProgram(*args, 5, *cheb)


def test_program_refuses_mixed_storage():
    """The kernel reads the A and C planes as one type."""
    sm, x, b = _smoother(2)
    mixed = FusedChebSmoother(sm.offsA, sm.planesA, sm.offsC,
                              sm.planesC.to(torch.bfloat16), sm.n, LMAX,
                              LMIN)
    with pytest.raises(TypeError, match="one storage type"):
        mixed.program()
    # the plain sweep on the CPU takes them as they are
    xs, _ = mixed.smooth_residual(None, x, b)
    assert torch.isfinite(xs).all()
