"""The cycle program of tpuamg_torch (amg/cycle_program.py), which the
persistent PCG kernel runs, and K7's counterpart dia_spmv_pallas.

* run_program_plain against vcycle_plain, bit for bit, for V and W
  cycles, pre/post 1 and 2, bf16 and f32 storage, at n=16
  (tests/test_torch_fused_pcg.py's size).
* A plain chunk driven through the program against pcg_chunk_plain, bit
  for bit, and pcg_fused over that chunk against the JAX package's
  pcg_fused in interpret mode, with test_torch_fused_pcg.py's checks.
* The op list and its barriers, the two x buffers per level,
  the level and op tables, and the table layouts against
  csrc/pcg_persistent.cu.
* dia_spmv_pallas on the unpadded x against dia_spmv_plain and against
  the JAX dia_spmv_pallas run in interpret mode, on 1024-aligned and on
  arbitrary offsets.
"""
import functools
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuamg_torch import state
from tpuamg_torch.amg import cycle_program as cp
from tpuamg_torch.amg import grid_fused
from tpuamg_torch.amg.grid_fused import (pcg_chunk_plain, pcg_fused,
                                         setup_grid_fused_pcg, vcycle_plain)
from tpuamg_torch.config import PRESETS
from tpuamg_torch.fem import mms
from tpuamg_torch.kernels import MAX_DIAGS
from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
from tpuamg_torch.sparse import dia_kernels
from tpuamg_torch.sparse.dia import DIA
from tpuamg_torch.sparse.dia_kernels import dia_spmv_pallas, dia_spmv_plain

N = 16


@functools.lru_cache(maxsize=None)
def _system(gamma):
    p = Params(2.0, 3.0, gamma)
    A, b, _, _ = get_system(get_mesh(N, 2), mms.setup_bidomain_mms(p, 2), p)
    return A, b


def _fused(cycle="v", coarse_dof=20, pre=1, post=1, storage=None,
           gamma=1e6):
    """n=16 fused PCG runner; coarse_dof 20 gives three smoothed levels
    (n 3072/1536/768) and a W-cycle's second visits."""
    A, b = _system(gamma)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type=cycle, coarse_dof=coarse_dof,
                  presmooth_iter=pre, postsmooth_iter=post)
    fp, slots, nflat = setup_grid_fused_pcg(
        A, (N + 1, N + 1), F=2, params=prm, storage_dtype=storage,
        device="cpu")
    bk = torch.zeros(nflat)
    bk[torch.as_tensor(slots)] = torch.as_tensor(b, dtype=torch.float32)
    return fp, bk


def _rhs(vc, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(vc.nflat),
                           dtype=torch.float32) * vc.mask_flat


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("post", [1, 2])
@pytest.mark.parametrize("pre", [1, 2])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_program_equals_vcycle_plain_bitwise(cycle, pre, post, storage):
    fp, _ = _fused(cycle, pre=pre, post=post, storage=storage)
    vc = fp.vc
    assert len(vc.spec.levels) == 3
    bm = _rhs(vc)
    z_ref = vcycle_plain(vc, bm).clone()
    z = cp.run_program_plain(cp.CycleProgram(vc), vc, bm)
    assert z.data_ptr() == vc._x[0].data_ptr()
    assert torch.equal(z, z_ref)
    assert float(torch.linalg.vector_norm(z_ref)) > 0


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_program_chunk_equals_pcg_chunk_plain(cycle):
    fp, bk = _fused(cycle)
    vc = fp.vc
    prog = cp.CycleProgram(vc)
    bm = bk * vc.mask_flat
    z0 = vcycle_plain(vc, bm).clone()

    def start():
        return (torch.zeros_like(bm), bm.clone(), torch.zeros_like(bm),
                z0.clone(), torch.tensor([-1.0]))
    ref = [t.clone() for t in pcg_chunk_plain(fp, *start(), 5)]
    got = pcg_chunk_plain(fp, *start(), 5,
                          cycle=lambda v, r: cp.run_program_plain(prog, v, r))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert float(ref[4][0, 0]) > 0          # alpha of the first iteration


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pcg_fused in interpret mode, once (the setting of
    tests/test_torch_fused_pcg.py's fixture)."""
    from tpuamg.amg.grid_fused import setup_grid_fused_pcg as jax_setup
    from tpuamg.amg.grid_fused import pcg_fused as jax_pcg_fused
    A, b = _system(1e8)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type="v", coarse_dof=128)
    jfp, slots, nflat = jax_setup(A, (N + 1, N + 1), F=2, params=prm,
                                  cheb_degree=3, interpret=True)
    bj = jnp.zeros(nflat, jnp.float32).at[jnp.asarray(slots)].set(
        jnp.asarray(b, jnp.float32))
    ref = jax_pcg_fused(jfp, bj, tol=1e-6, maxiter=30, chunk=8)
    fp = state.fused_pcg_from_jax(jfp, 2, device="cpu")
    return fp, slots, b, ref


def test_program_pcg_matches_jax_kernel(jax_run):
    """pcg_fused with every chunk's cycle run from the program, against
    the JAX kernel: test_pcg_fused_matches_jax_kernel's checks (the
    second residual at 1e-3, for the reason given there)."""
    fp, slots, b, ref = jax_run
    prog = cp.CycleProgram(fp.vc)
    bk = torch.zeros(fp.vc.nflat)
    bk[torch.as_tensor(slots)] = torch.as_tensor(b, dtype=torch.float32)
    fp.run_chunk = lambda *a: pcg_chunk_plain(
        fp, *a, cycle=lambda v, r: cp.run_program_plain(prog, v, r))
    got = pcg_fused(fp, bk, tol=1e-6, maxiter=30, chunk=8)
    assert got.converged
    assert abs(got.niters - ref.niters) <= 1, (got.niters, ref.niters)
    np.testing.assert_allclose(got.residuals[0], ref.residuals[0],
                               rtol=1e-4)
    np.testing.assert_allclose(got.residuals[1], ref.residuals[1],
                               rtol=1e-3)
    np.testing.assert_allclose(got.alphas[:2], ref.alphas[:2], rtol=1e-4)
    m = min(len(got.residuals), len(ref.residuals))
    np.testing.assert_allclose(got.residuals[:m], ref.residuals[:m],
                               rtol=5e-2)
    r_true = float(torch.linalg.vector_norm(bk - fp.Q.matvec(got.x)))
    assert r_true <= 2e-6 * got.true_residuals[0]


def _visits(spec):
    """Level visits per cycle, as _run_cycle makes them."""
    out, mult = [], 1
    for lv in range(len(spec.levels)):
        if lv and spec.cycle == "w" and 2 ** lv <= spec.max_w_work:
            mult *= 2
        out.append(mult)
    return out


@pytest.mark.parametrize("pre,post", [(1, 1), (1, 2), (2, 1), (2, 2),
                                      (0, 1)])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_program_ops_and_barriers(cycle, pre, post):
    fp, _ = _fused(cycle, pre=pre, post=post)
    spec = fp.vc.spec
    prog = cp.CycleProgram(fp.vc)
    # a grid barrier after every op but the last, a step on level 0 (the
    # kernel's r.z reads z[i] in the thread that wrote it)
    assert all(op.barrier for op in prog.ops[:-1])
    last = prog.ops[-1]
    assert (last.kind, last.level, last.barrier) == (cp.CHEB_STEP, 0, False)
    assert prog.grid_barriers() == len(prog) - 1
    # the recursion: per visit pre + post sweeps of `degree` steps, one
    # residual-restriction and one prolongation; the coarse solve once per
    # visit of the last level; a cold visit starts with a cold step, or
    # with ZERO when it has no pre-smoothing
    visits = _visits(spec)
    per = {name: 0 for name in cp.OP_NAMES}
    for op in prog.ops:
        per[cp.OP_NAMES[op.kind]] += 1
    S0 = spec.levels[0]
    steps = S0.degree * (S0.pre + S0.post)
    assert (S0.pre, S0.post) == (pre, post)
    cold_visits = 1 + sum(visits[:-1])
    assert per["RESID_RESTRICT"] == per["PROLONG"] == sum(visits)
    assert per["CHEB_STEP"] == steps * sum(visits)
    assert per["ZERO"] == (0 if pre else cold_visits)
    assert per["COARSE_GEMV"] == per["COARSE_REDUCE"] == visits[-1]
    assert sum(op.cold for op in prog.ops) == (cold_visits if pre else 0)
    assert prog.counts() == {k: v for k, v in per.items() if v}


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_program_buffers(cycle):
    """Each step reads one x buffer and writes the other, a cold step
    reads none, every visit of a level ends in the buffer its
    prolongation then reads, and level 0 ends in buffer 0 (vc's fine x,
    where pcg_chunk reads z)."""
    fp, _ = _fused(cycle, pre=2, post=1)
    prog = cp.CycleProgram(fp.vc)
    cur = {}
    for op in prog.ops:
        if op.kind == cp.CHEB_STEP:
            if not op.cold:
                assert op.src == cur[op.level] and op.dst != op.src, op
            cur[op.level] = op.dst
        elif op.kind in (cp.RESID_RESTRICT, cp.PROLONG):
            assert op.src == cur[op.level], op
            if op.kind == cp.PROLONG and op.level + 1 in cur:
                assert op.nsrc == cur[op.level + 1], op
    assert cur[0] == 0


def test_zero_op_without_presmoothing():
    """pre = 0: a cold visit starts with ZERO, in the buffer that makes
    the level end in buffer 0; the program still equals vcycle_plain."""
    fp, _ = _fused("w", pre=0, post=1)
    vc = fp.vc
    prog = cp.CycleProgram(vc)
    zeros = [op for op in prog.ops if op.kind == cp.ZERO]
    assert len(zeros) == 1 + sum(_visits(vc.spec)[:-1])
    degree = vc.spec.levels[0].degree
    assert all(op.dst == degree % 2 for op in zeros)
    assert not any(op.cold for op in prog.ops)
    bm = _rhs(vc, 3)
    z_ref = vcycle_plain(vc, bm).clone()
    assert torch.equal(cp.run_program_plain(prog, vc, bm), z_ref)


def test_program_tables():
    """The device tables hold vc's own buffers (and the program's second
    x buffers), sizes and offsets, and the op records' fields and float32
    coefficients."""
    fp, _ = _fused("w", storage=torch.bfloat16)
    vc = fp.vc
    spec = vc.spec
    prog = cp.CycleProgram(vc)
    lt = prog.levels_dev.numpy()
    assert lt.shape == (len(spec.levels), cp.LEVEL_WORDS)
    for lv, S in enumerate(spec.levels):
        row = lt[lv]
        last = lv + 1 == len(spec.levels)
        assert row[cp.L_A] == vc.A_planes[lv].data_ptr()
        assert row[cp.L_C] == vc.C_planes[lv].data_ptr()
        assert row[cp.L_M] == vc.M_planes[lv].data_ptr()
        assert row[cp.L_X0] == vc._x[lv].data_ptr()
        assert row[cp.L_X1] == prog.x_alt[lv].data_ptr()
        assert row[cp.L_D] == vc._d[lv].data_ptr()
        assert row[cp.L_B] == (0 if lv == 0 else vc._b[lv - 1].data_ptr())
        assert row[cp.L_NEXT_B] == (vc._bc if last else vc._b[lv]
                                    ).data_ptr()
        assert row[cp.L_NEXT_X0] == (vc._xc if last else vc._x[lv + 1]
                                     ).data_ptr()
        assert row[cp.L_NEXT_X1] == (vc._xc if last
                                     else prog.x_alt[lv + 1]).data_ptr()
        assert row[cp.L_N] == S.n
        assert row[cp.L_N_NEXT] == (spec.nc if last
                                    else spec.levels[lv + 1].n)
        assert (row[cp.L_K], row[cp.L_F]) == (S.K, spec.F)
        assert row[cp.L_KC] == (spec.Kc if last else spec.levels[lv + 1].K)
        nl = row[cp.L_NLEAD]
        assert tuple(row[cp.L_LEAD:cp.L_LEAD + nl]) == tuple(
            d // 2 for d in S.lead)
        nda, ndc = row[cp.L_NDA], row[cp.L_NDC]
        assert tuple(row[cp.L_OFFA:cp.L_OFFA + nda]) == S.offsA
        assert tuple(row[cp.L_OFFC:cp.L_OFFC + ndc]) == S.offsC
    assert prog.partial.numel() == prog.nsplit * spec.nc
    assert -(-spec.nc // prog.nsplit) <= 16 or prog.nsplit == 64
    ot = prog.ops_dev.numpy()
    assert ot.shape == (len(prog), cp.OP_WORDS)
    assert prog.shared_bytes() == lt.nbytes + ot.nbytes
    for op, rec in zip(prog.ops, ot):
        w0 = int(rec[0])
        flags = w0 >> 16
        assert w0 & 0xff == op.kind
        assert (w0 >> 8) & 0xff == (cp.COARSE_LEVEL if op.level < 0
                                    else op.level)
        assert bool(flags & cp.F_FIRST) == op.first
        assert bool(flags & cp.F_NO_BARRIER) == (not op.barrier)
        assert bool(flags & cp.F_COLD) == op.cold
        assert (bool(flags & cp.F_SRC), bool(flags & cp.F_DST),
                bool(flags & cp.F_NSRC)) == (op.src, op.dst, op.nsrc)
        np.testing.assert_array_equal(
            rec[1:3].view(np.float32), np.float32([op.s, op.c]))
        assert rec[3] == 0
    steps = [op for op in prog.ops if op.kind == cp.CHEB_STEP]
    S0 = spec.levels[0]
    assert steps[0].first and steps[0].cold
    assert steps[0].s == 1.0 / S0.theta
    assert (steps[1].s, steps[1].c) == S0.coefs[0]


def test_program_refuses_c_across_node_blocks():
    """The fused step reads C t inside node blocks held by one warp."""
    fp, _ = _fused("v")
    vc = fp.vc
    offs = vc.spec.levels[0].offsC
    d = offs.index(1)
    planes = vc.C_planes[0]
    keep = planes[d, 1].clone()
    planes[d, 1] = 0.5            # row 1 (f = 1) reading row 2: a new node
    with pytest.raises(ValueError, match="crosses node blocks"):
        cp.CycleProgram(vc)
    planes[d, 1] = keep
    cp.CycleProgram(vc)


def _enum_values(src, name):
    """{member: value} of a C enum in src (explicit values and the
    members before them)."""
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    consts = {"kMaxDiags": MAX_DIAGS}
    out, nxt = {}, 0
    for item in (t.strip() for t in body.split(",")):
        if not item:
            continue
        key, _, expr = (s.strip() for s in item.partition("="))
        if expr:
            nxt = eval(expr, {}, {**consts, **out})
        out[key] = nxt
        nxt += 1
    return out


def test_table_layouts_match_cuda_source():
    """The words that cycle_program.py and grid_fused.py write are the
    ones csrc/pcg_persistent.cu reads (the card checks the built library
    too)."""
    src = (Path(cp.__file__).resolve().parents[1] / "csrc"
           / "pcg_persistent.cu").read_text()
    lw = _enum_values(src, "LevelWord")
    assert lw.pop("kLevelWords") == cp.LEVEL_WORDS
    names = ("A", "C", "M", "X0", "X1", "D", "B", "NextB", "NextX0",
             "NextX1", "N", "NNext", "K", "Kc", "F", "NLead", "Lead", "NdA",
             "NdC", "OffA", "OffC")
    py = ("A", "C", "M", "X0", "X1", "D", "B", "NEXT_B", "NEXT_X0",
          "NEXT_X1", "N", "N_NEXT", "K", "KC", "F", "NLEAD", "LEAD", "NDA",
          "NDC", "OFFA", "OFFC")
    assert sorted(lw) == sorted("k" + c for c in names)
    for c, p in zip(names, py):
        assert lw["k" + c] == getattr(cp, "L_" + p), c
    ops = _enum_values(src, "OpKind")
    assert [ops[k] for k in ("kZero", "kChebStep", "kResidRestrict",
                             "kProlong", "kCoarseGemv", "kCoarseReduce")] \
        == [cp.ZERO, cp.CHEB_STEP, cp.RESID_RESTRICT, cp.PROLONG,
            cp.COARSE_GEMV, cp.COARSE_REDUCE]
    flags = _enum_values(src, "OpFlag")
    assert flags == dict(fFirst=cp.F_FIRST, fCold=cp.F_COLD, fSrc=cp.F_SRC,
                         fDst=cp.F_DST, fNSrc=cp.F_NSRC,
                         fNoBarrier=cp.F_NO_BARRIER)
    args = _enum_values(src, "ArgWord")
    assert args.pop("kNArgs") == len(grid_fused._PERSISTENT_ARGS)
    assert [k[1:].lower() for k in sorted(args, key=args.get)] == [
        k.replace("_", "").lower() for k in grid_fused._PERSISTENT_ARGS]
    assert re.search(r"constexpr int kOpWords = %d;" % cp.OP_WORDS, src)
    assert re.search(r"constexpr int kMaxDiags = %d;" % MAX_DIAGS, src)


# ---------------------------------------------------------------------------
# K7's counterpart: dia_spmv_pallas on the unpadded x
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX dia_spmv_pallas with its pallas_call in interpret mode (the
    TPU kernel cannot run on the CPU otherwise); the JAX package's module
    is untouched outside this test."""
    from tpuamg.sparse import pallas_kernels as pk
    real = pk.pl

    class _Interpret:
        def __getattr__(self, name):
            if name == "pallas_call":
                return functools.partial(real.pallas_call, interpret=True)
            return getattr(real, name)
    monkeypatch.setattr(pk, "pl", _Interpret())
    pk._dia_spmv_call.clear_cache()
    yield pk.dia_spmv_pallas
    pk._dia_spmv_call.clear_cache()


@pytest.mark.parametrize("offsets", [
    (-2048, -1024, 0, 1024, 3072),          # the JAX kernel's alignment
    (-1155, -1027, -130, -3, -1, 0, 1, 3, 127, 1026, 1155),   # any
])
def test_dia_spmv_pallas_matches_jax_interpret(offsets,
                                               jax_pallas_interpret):
    from tpuamg.sparse.dia import DIA as JDIA
    n = 8192 + 77
    rng = np.random.default_rng(11)
    data = rng.standard_normal((len(offsets), n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    y_jax = np.asarray(jax_pallas_interpret(
        JDIA(offsets, jnp.asarray(data), (n, n)), jnp.asarray(x),
        block=4096))
    xt = torch.as_tensor(x)
    y = dia_spmv_pallas(DIA(offsets, torch.as_tensor(data), (n, n)), xt)
    assert y.shape == (n,)
    # the same function on the unpadded x: the plain sweep, bit for bit
    assert torch.equal(y, dia_spmv_plain(offsets, torch.as_tensor(data),
                                         xt))
    # float32 sums in another order
    err = np.abs(y.numpy() - y_jax).max() / np.abs(y_jax).max()
    assert err < 1e-6, err


def test_dia_spmv_pallas_passes_x_unpadded(monkeypatch):
    """No padded copy: K1's wrapper gets the caller's x itself, with no
    x_pad (the entry whose bounds checks give the zero halo)."""
    seen = []

    def spy(offsets, planes, x, *args, **kw):
        seen.append((x, args, kw))
        return dia_spmv_plain(offsets, planes, x)
    monkeypatch.setattr(dia_kernels, "dia_spmv", spy)
    offs = (-300, -1, 0, 2, 299)
    planes = torch.randn(len(offs), 1000)
    x = torch.randn(1000)
    dia_spmv_pallas(DIA(offs, planes, (1000, 1000)), x, block=8192)
    assert len(seen) == 1
    assert seen[0][0] is x and seen[0][1] == () and seen[0][2] == {}
