"""tpuamg_torch's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports no JAX; on the card run it without the repo's
conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is there and skips
otherwise."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_planes(n, nd, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((nd, n)),
                           dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_dia_kernel_matches_plain(dtype, residual):
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import dia_spmv, dia_spmv_plain
    dev = _card()
    n = 70_001
    offsets = (-1155, -1027, -130, -3, -1, 0, 1, 3, 127, 1026, 1155)
    planes = _random_planes(n, len(offsets), dtype, 0).to(dev)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(dev)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32
                        ).to(dev) if residual else None
    before = kernels.LAUNCHES["dia_residual" if residual else "dia_spmv"]
    y = dia_spmv(offsets, planes, x, b)
    torch.cuda.synchronize()
    ref = dia_spmv_plain(offsets, planes, x, b)
    # float32 sums in another order: relative 1e-5 of the largest entry
    err = float((y - ref).abs().max() / ref.abs().max())
    assert err < 1e-5, err
    assert kernels.LAUNCHES["dia_residual" if residual else "dia_spmv"] \
        == before + 1


def test_dia_kernel_rejects_bad_input():
    from tpuamg_torch.sparse.dia_kernels import dia_spmv
    dev = _card()
    planes = torch.zeros((3, 100), device=dev)
    x = torch.zeros(100, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        dia_spmv((-1, 0, 1), planes, x)
    with pytest.raises(ValueError):
        dia_spmv((-1, 0, 1), planes[:, :50], x.float())


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_cycle_kernels_match_plain(storage, cycle):
    from dataclasses import replace
    from tpuamg_torch import kernels
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    from tpuamg_torch.amg.grid_fused import (setup_grid_fused, vcycle,
                                             vcycle_plain)
    dev = _card()
    n = 64
    p = Params(2.0, 3.0, 1e6)
    A, b, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type=cycle, coarse_dof=200)
    vc, slots, nflat = setup_grid_fused(A, (n + 1, n + 1), F=2, params=prm,
                                        cheb_degree=4, storage_dtype=storage,
                                        device=dev)
    rng = np.random.default_rng(2)
    bm = torch.as_tensor(rng.standard_normal(nflat), dtype=torch.float32
                         ).to(dev) * vc.mask_flat
    before = kernels.LAUNCHES["vcycle"]
    z = vcycle(vc, bm).clone()
    torch.cuda.synchronize()
    z_ref = vcycle_plain(vc, bm).clone()
    err = float(torch.linalg.vector_norm(z - z_ref)
                / torch.linalg.vector_norm(z_ref))
    assert err < 1e-4, err
    assert kernels.LAUNCHES["vcycle"] == before + 1
    for name in ("cheb_apply", "restrict", "prolong", "coarse_gemv",
                 "coarse_reduce", "dia_residual"):
        assert kernels.LAUNCHES[name] > 0, name


# ---------------------------------------------------------------------------
# K3: the Chebyshev sweep
# ---------------------------------------------------------------------------

def _cheb_inputs(dev, storage, n=98_306, F=2, seed=3):
    """A diagonally dominant random DIA over a 2D-grid-like offset set and
    its (2F-1)-offset block inverse, as the grid path builds them."""
    from tpuamg_torch.sparse.dia_kernels import _cheb_coefs
    rng = np.random.default_rng(seed)
    offsA = (-2 * 257 - 1, -2 * 257, -2, -1, 0, 1, 2, 2 * 257, 2 * 257 + 1)
    planes = rng.standard_normal((len(offsA), n)) * 0.1
    planes[offsA.index(0)] = 2.0 + rng.random(n)
    offsC = tuple(range(-(F - 1), F))
    cplanes = rng.standard_normal((len(offsC), n)) * 0.05
    cplanes[offsC.index(0)] += 0.5
    theta, coefs = _cheb_coefs(2.2, 0.275, 3)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)

    def dev_planes(p):
        return torch.as_tensor(p, dtype=torch.float32).to(storage).to(dev)
    return (offsA, dev_planes(planes), offsC, dev_planes(cplanes),
            x.to(dev), b.to(dev), theta, coefs)


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_r", [False, True])
def test_cheb_sweep_kernel_matches_plain(storage, want_r):
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import cheb_sweep, cheb_sweep_plain
    dev = _card()
    offsA, pA, offsC, pC, x, b, theta, coefs = _cheb_inputs(dev, storage)
    before = kernels.LAUNCHES["cheb_sweep"]
    for iters in (1, 2):
        xk, rk = cheb_sweep(offsA, pA, offsC, pC, x, b, theta, coefs, 3,
                            iters, want_r)
        torch.cuda.synchronize()
        xp, rp = cheb_sweep_plain(offsA, pA, offsC, pC, x, b, theta, coefs,
                                  3, iters, want_r)
        err = float(torch.linalg.vector_norm(xk - xp)
                    / torch.linalg.vector_norm(xp))
        assert err < 1e-5, (iters, err)
        if want_r:
            err_r = float(torch.linalg.vector_norm(rk - rp)
                          / torch.linalg.vector_norm(rp))
            assert err_r < 1e-5, (iters, err_r)
        else:
            assert rk is None
    # one launch count per smoother application, x left unchanged
    assert kernels.LAUNCHES["cheb_sweep"] == before + 2
    assert torch.equal(x, _cheb_inputs(dev, storage)[4])


def test_fused_cheb_smoother_kernel_on_grid_level():
    """Level 0 of the route-(c) hierarchy (setup_grid, f32): the kernel
    classes' smooth and smooth_residual against their plain versions."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid import setup_grid
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    from tpuamg_torch.sparse.dia_kernels import FusedChebSmoother, \
        cheb_sweep_plain, _cheb_coefs
    dev = _card()
    n = 64
    p = Params(2.0, 3.0, 1e6)
    A, _, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    prec, slots, nd = setup_grid(A, (n + 1, n + 1), F=2,
                                 params=PRESETS["metric_schwarz"],
                                 dtype=torch.float32, device=dev)
    L0 = prec.levels[0]
    sm = L0.smoother
    assert isinstance(sm, FusedChebSmoother)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(nd), dtype=torch.float32
                        ).to(dev)
    b = torch.as_tensor(rng.standard_normal(nd), dtype=torch.float32
                        ).to(dev)
    before = kernels.LAUNCHES["cheb_sweep"]
    xs, r = sm.smooth_residual(L0.A, x, b)
    x2 = sm.smooth(L0.A, x, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cheb_sweep"] == before + 2
    theta, coefs = _cheb_coefs(sm.lmax, sm.lmin, sm.degree, sm.kind)
    xp, rp = cheb_sweep_plain(sm.offsA, sm.planesA, sm.offsC, sm.planesC,
                              x, b, theta, coefs, sm.degree, 1, True)
    for got, ref in ((xs, xp), (x2, xp), (r, rp)):
        err = float(torch.linalg.vector_norm(got - ref)
                    / torch.linalg.vector_norm(ref))
        assert err < 1e-5, err


# ---------------------------------------------------------------------------
# K5: the PCG chunk as one persistent cooperative launch
# ---------------------------------------------------------------------------

def _pcg_setup(dev, cycle, n=32, gamma=1e6, storage=None, **prm_kw):
    from dataclasses import replace
    from tpuamg_torch.amg.grid_fused import setup_grid_fused_pcg
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, gamma)
    A, b, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type=cycle, **prm_kw)
    fp, slots, nflat = setup_grid_fused_pcg(A, (n + 1, n + 1), F=2,
                                            params=prm,
                                            storage_dtype=storage,
                                            device=dev)
    bk = torch.zeros(nflat, dtype=torch.float32)
    bk[torch.as_tensor(slots)] = torch.as_tensor(b, dtype=torch.float32)
    return fp, bk.to(dev)


def _chunk_start(fp, bk):
    """The first chunk's inputs (x = 0, r = b, p = 0, z = M b, rz_prev =
    -1: beta = 0) as a function that makes fresh copies."""
    bm = bk * fp.vc.mask_flat
    z0 = fp.vc.matvec(bm).clone()
    return lambda: (torch.zeros_like(bm), bm.clone(), torch.zeros_like(bm),
                    z0.clone(), torch.full((1,), -1.0, device=bm.device))


# The limits on stats rows 0-1 at n=32, by gamma: (relative error over
# the rows, relative error of one entry).  At gamma 1e6 the first
# iteration removes all but ~1e-5 of rz, and the cancellation in
# r = r - alpha q amplifies one f32 rounding to ~1e-5 of the rows and
# ~1e-4 of an entry: two f32 chunks that differ only in where they round
# disagree by that much.  scripts/torch_chunk_row_noise.py measures it
# with the plain chunk, its starting z shared (CPU): fused updates, q =
# Q p accumulated in f64, or 1e-7 relative noise in every cycle's z move
# the first chunk's rows by up to 2.1e-5 and an entry by up to 8.9e-5,
# the second chunk's entries by up to 1.005e-4.  So 4e-5 and 2.5e-4 at
# gamma 1e6.  The control, a cycle whose z is 5e-4 too large, moves an
# entry by 5.0e-4 and fails (test_pcg_chunk_kernel_matches_plain).
ROWS_RTOL = {1.0: (1e-5, 1e-4), 1e6: (4e-5, 2.5e-4)}


def _check_chunks(got, ref, chunk, rtol=ROWS_RTOL[1.0]):
    """Two chunks from one start: stats rows 0-1 (alpha, beta, sqrt|rz|,
    ||r||, ||x||) to rtol = (over the rows, per entry) (ROWS_RTOL), x to
    1e-3.  Later iterations drift apart by the rows' f32
    noise, as the JAX package's fused and unfused PCG do
    (tests/test_grid_fused_pcg.py: 5e-2)."""
    x, st = got[0], got[4]
    xp, stp = ref[0], ref[4]
    rows = st[:2, :5].double().cpu().numpy()
    rows_p = stp[:2, :5].double().cpu().numpy()
    assert np.linalg.norm(rows - rows_p) <= rtol[0] * np.linalg.norm(
        rows_p)
    np.testing.assert_allclose(rows, rows_p, rtol=rtol[1])
    np.testing.assert_allclose(st[chunk, :2].double().cpu().numpy(),
                               stp[chunk, :2].double().cpu().numpy(),
                               rtol=5e-2)
    assert _rel(x, xp) < 1e-3


def _clone_all(out):
    return tuple(t.clone() for t in out)


@pytest.mark.parametrize("storage,gamma", [
    (torch.float32, 1e6),
    # gamma 1 for bf16 planes: at gamma 1e6 the bf16 W-cycle is nearly
    # indefinite here (alpha 2.7e-8)
    (torch.float32, 1.0), (torch.bfloat16, 1.0)])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_pcg_chunk_kernel_matches_plain(cycle, storage, gamma):
    """The persistent chunk (one launch, the cycle inside) against the
    plain chunk: the first chunk (rz_prev = -1: beta = 0) and a second
    one that carries rz.  Control: a plain chunk whose cycle returns z
    5e-4 too large fails the same check."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid_fused import (pcg_chunk, pcg_chunk_plain,
                                             vcycle_plain)
    dev = _card()
    fp, bk = _pcg_setup(dev, cycle, storage=storage, gamma=gamma)
    start = _chunk_start(fp, bk)
    chunk = 4
    kernels.reset_launches()
    got = _clone_all(pcg_chunk(fp, *start(), chunk))
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"pcg_chunk": 1}
    ref = _clone_all(pcg_chunk_plain(fp, *start(), chunk))
    _check_chunks(got, ref, chunk, ROWS_RTOL[gamma])
    bad = _clone_all(pcg_chunk_plain(
        fp, *start(), chunk, cycle=lambda vc, r: vcycle_plain(vc, r)
        * (1 + 5e-4)))
    with pytest.raises(AssertionError):
        _check_chunks(bad, ref, chunk, ROWS_RTOL[gamma])
    # a second chunk carries rz across: both continue from the kernel's
    # state
    x, r, p, z, st = got
    carry = st[chunk, 1:2].clone()
    st2 = pcg_chunk(fp, x.clone(), r.clone(), p.clone(), z.clone(), carry,
                    chunk)[4].clone()
    st2p = pcg_chunk_plain(fp, x.clone(), r.clone(), p.clone(), z.clone(),
                           carry, chunk)[4]
    np.testing.assert_allclose(st2[:2, :5].double().cpu().numpy(),
                               st2p[:2, :5].double().cpu().numpy(),
                               rtol=ROWS_RTOL[gamma][1])


@pytest.mark.parametrize("gamma", [1e6, 1.0])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_pcg_chunk_kernel_matches_sequenced(cycle, gamma):
    """The persistent chunk against the earlier design, three pcg.cu
    launches per iteration around K2's host-sequenced cycle."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid_fused import pcg_chunk, pcg_chunk_sequenced
    dev = _card()
    fp, bk = _pcg_setup(dev, cycle, gamma=gamma)
    start = _chunk_start(fp, bk)
    chunk = 4
    kernels.reset_launches()
    seq = _clone_all(pcg_chunk_sequenced(fp, *start(), chunk))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pcg_chunk_sequenced"] == 1
    assert kernels.LAUNCHES["pcg_pq"] == kernels.LAUNCHES["vcycle"] == chunk
    assert kernels.LAUNCHES["pcg_chunk"] == 0
    got = _clone_all(pcg_chunk(fp, *start(), chunk))
    _check_chunks(got, seq, chunk, ROWS_RTOL[gamma])


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cycle,pre", [("v", 1), ("w", 1), ("w", 0)])
def test_pcg_chunk_kernel_every_op_kind(cycle, pre, storage):
    """n=16, coarse_dof 20, gamma 1: three smoothed levels (n
    3072/1536/768) and a coarse T of 147,456 entries, so every op kind
    runs; pre-smoothing 1 has cold steps, 0 the ZERO op."""
    from tpuamg_torch.amg import cycle_program as cp
    from tpuamg_torch.amg.grid_fused import pcg_chunk, pcg_chunk_plain
    dev = _card()
    fp, bk = _pcg_setup(dev, cycle, n=16, gamma=1.0, storage=storage,
                        coarse_dof=20, presmooth_iter=pre)
    assert len(fp.vc.spec.levels) == 3
    prog = fp.program()
    kinds = {cp.OP_NAMES[op.kind] for op in prog.ops}
    assert kinds == set(cp.OP_NAMES) - {"ZERO" if pre else ""}
    assert any(op.cold for op in prog.ops) == bool(pre)
    start = _chunk_start(fp, bk)
    got = _clone_all(pcg_chunk(fp, *start(), 3))
    torch.cuda.synchronize()
    ref = _clone_all(pcg_chunk_plain(fp, *start(), 3))
    _check_chunks(got, ref, 3)


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_pcg_fused_kernel_crosses_tolerance_mid_chunk(cycle):
    """pcg_fused through the persistent K5 against the same host loop over
    the plain chunk: the history is cut at the first crossing, inside a
    chunk; one launch per chunk and no sequenced launch."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid_fused import pcg_fused, pcg_chunk_plain
    dev = _card()
    fp, bk = _pcg_setup(dev, cycle)
    run_kernel = fp.run_chunk
    fp.run_chunk = lambda *a: pcg_chunk_plain(fp, *a)
    probe = pcg_fused(fp, bk, tol=2e-5, maxiter=60, chunk=60)
    # a chunk length that does not divide the iteration count
    chunk = next(c for c in (7, 6, 5, 4, 3) if probe.niters % c)
    ref = pcg_fused(fp, bk, tol=2e-5, maxiter=60, chunk=chunk)
    fp.run_chunk = run_kernel
    kernels.reset_launches()
    got = pcg_fused(fp, bk, tol=2e-5, maxiter=60, chunk=chunk)
    torch.cuda.synchronize()
    assert got.converged and ref.converged
    assert abs(got.niters - ref.niters) <= 1
    n_chunks = kernels.LAUNCHES["pcg_chunk"]
    assert n_chunks == -(-got.niters // chunk)
    for name in ("pcg_rz", "pcg_pq", "pcg_xr", "pcg_finish"):
        assert kernels.LAUNCHES[name] == 0, name
    assert kernels.LAUNCHES["vcycle"] == 1          # z0 only
    np.testing.assert_allclose(got.residuals[:2], ref.residuals[:2],
                               rtol=1e-4)
    np.testing.assert_allclose(got.alphas[:2], ref.alphas[:2], rtol=1e-4)


def test_pcg_chunk_kernel_is_deterministic():
    """Fixed-order reductions on a fixed grid: the same chunk from the
    same state gives the same bits."""
    from tpuamg_torch.amg.grid_fused import pcg_chunk
    dev = _card()
    fp, bk = _pcg_setup(dev, "w")
    start = _chunk_start(fp, bk)
    outs = [_clone_all(pcg_chunk(fp, *start(), 5)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_pcg_chunk_kernel_too_large_grid_raises():
    """A grid that cannot be co-resident is refused by the cooperative
    launch, and the wrapper raises naming the grid and the occupancy;
    nothing falls back to the sequenced chunk."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid_fused import (_pcg_chunk_persistent,
                                             pcg_chunk, persistent_grid)
    dev = _card()
    fp, bk = _pcg_setup(dev, "v", n=16)
    start = _chunk_start(fp, bk)
    _, per_sm, sms = persistent_grid(fp)
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="resident blocks per SM"):
        _pcg_chunk_persistent(fp, *start(), 2, _grid=per_sm * sms + 1)
    assert not any(kernels.LAUNCHES.values())
    pcg_chunk(fp, *start(), 2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pcg_chunk"] == 1


# ---------------------------------------------------------------------------
# K6 (the sharded Chebyshev step), K1's padded-x entry, and the
# distributed grid solve on a one-rank NCCL group
# ---------------------------------------------------------------------------

def _step_inputs(dev, storage, n=98_304, F=2, seed=5):
    """A diagonally dominant random DIA and the masked block inverse of
    random F x F node blocks as C planes (sparse.dia_kernels.blockinv_dia),
    as the distributed grid path builds them."""
    from tpuamg_torch.sparse.dia_kernels import blockinv_dia
    rng = np.random.default_rng(seed)
    offsA = (-2 * 257 - 1, -2 * 257, -2, -1, 0, 1, 2, 2 * 257, 2 * 257 + 1)
    planes = rng.standard_normal((len(offsA), n)) * 0.1
    planes[offsA.index(0)] = 2.0 + rng.random(n)
    blockinv = np.linalg.inv(rng.standard_normal((n // F, F, F)) * 0.1
                             + 2 * np.eye(F))
    mask = np.ones(n)
    mask[-7:] = 0.0
    offsC, cdata = blockinv_dia(blockinv, mask)

    def dev_planes(p):
        return torch.as_tensor(p, dtype=torch.float32).to(storage).to(dev)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(dev)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(dev)
    return offsA, dev_planes(planes), tuple(offsC), dev_planes(cdata), x, b


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("first", [True, False])
def test_cheb_step_kernel_matches_plain(storage, first):
    from tpuamg_torch import kernels
    from tpuamg_torch.dist.dist_kernels import (cheb_step, cheb_step_plain,
                                                halo_shards)
    dev = _card()
    ndev, F = 8, 2
    offsA, pA, offsC, pC, x, b = _step_inputs(dev, storage)
    h = max(abs(o) for o in offsA)
    nl = x.shape[0] // ndev
    d = torch.as_tensor(np.random.default_rng(6).standard_normal(
        x.shape[0]), dtype=torch.float32).to(dev)
    before = kernels.LAUNCHES["cheb_step"]
    for r, xh in enumerate(halo_shards(x, h, ndev)):
        rows = slice(r * nl, (r + 1) * nl)
        args = (offsA, pA[:, rows].contiguous(), offsC,
                pC[:, rows].contiguous(), xh, h, b[rows].contiguous(),
                d[rows].contiguous(), first, 0.7, 0.3)
        xk, dk = cheb_step(*args, F)
        torch.cuda.synchronize()
        xp, dp = cheb_step_plain(*args)
        assert _rel(xk, xp) < 1e-5, r
        assert _rel(dk, dp) < 1e-5, r
    assert kernels.LAUNCHES["cheb_step"] == before + ndev


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_sharded_cheb_steps_match_k3(storage):
    """Eight in-process shards, each step on halo'd slices (K6), then the
    residual through K1's padded-x entry, against K3's sweep of the whole
    level."""
    from tpuamg_torch.dist.dist_kernels import cheb_step, halo_shards
    from tpuamg_torch.sparse.dia_kernels import (_cheb_coefs, cheb_sweep,
                                                 dia_spmv)
    dev = _card()
    ndev, F, degree = 8, 2, 3
    offsA, pA, offsC, pC, x, b = _step_inputs(dev, storage, seed=7)
    theta, coefs = _cheb_coefs(2.2, 0.275, degree)
    h = max(abs(o) for o in offsA)
    nl = x.shape[0] // ndev
    rows = [slice(r * nl, (r + 1) * nl) for r in range(ndev)]
    pAs = [pA[:, s].contiguous() for s in rows]
    pCs = [pC[:, s].contiguous() for s in rows]
    bs = [b[s].contiguous() for s in rows]
    ds = [torch.zeros(nl, device=dev) for _ in rows]
    steps = [(True, 1.0 / theta, 0.0)] + [(False, a, c) for a, c in coefs]
    xs = x.clone()
    for first, s, c in steps:
        xhs = halo_shards(xs, h, ndev)
        xs = torch.cat([cheb_step(offsA, pAs[r], offsC, pCs[r], xhs[r], h,
                                  bs[r], ds[r], first, s, c, F,
                                  d_out=ds[r])[0] for r in range(ndev)])
    rs = torch.cat([dia_spmv(offsA, pAs[r], xh, bs[r], x_pad=h)
                    for r, xh in enumerate(halo_shards(xs, h, ndev))])
    x3, r3 = cheb_sweep(offsA, pA, offsC, pC, x, b, theta, coefs, degree,
                        1, True)
    torch.cuda.synchronize()
    assert _rel(xs, x3) < 1e-5
    assert _rel(rs, r3) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_dia_padded_entry_matches_plain(dtype, residual):
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia import DIA
    from tpuamg_torch.sparse.dia_kernels import (dia_spmv, dia_spmv_pallas,
                                                 dia_spmv_plain)
    dev = _card()
    n, pad = 70_001, 1200
    offsets = (-1155, -1027, -130, -3, -1, 0, 1, 3, 127, 1026, 1155)
    planes = _random_planes(n, len(offsets), dtype, 0).to(dev)
    rng = np.random.default_rng(1)
    # a shard's buffer: nonzero halos on both sides
    xh = torch.as_tensor(rng.standard_normal(n + 2 * pad),
                         dtype=torch.float32).to(dev)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32
                        ).to(dev) if residual else None
    name = ("dia_residual" if residual else "dia_spmv") + "_pad"
    before = kernels.LAUNCHES[name]
    y = dia_spmv(offsets, planes, xh, b, x_pad=pad)
    torch.cuda.synchronize()
    ref = dia_spmv_plain(offsets, planes, xh, b, x_pad=pad)
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-5
    assert kernels.LAUNCHES[name] == before + 1
    # x_pad = 0 is the unpadded entry, bit for bit
    x = xh[pad:pad + n].contiguous()
    assert torch.equal(dia_spmv(offsets, planes, x, b, x_pad=0),
                       dia_spmv(offsets, planes, x, b))
    if not residual:
        # K7's counterpart over these arbitrary (not 1024-aligned) offsets
        yk = dia_spmv_pallas(DIA(offsets, planes, (n, n)), x)
        yp = dia_spmv_plain(offsets, planes, x)
        assert float((yk - yp).abs().max() / yp.abs().max()) < 1e-5


def test_cheb_step_kernel_rejects_bad_input():
    from tpuamg_torch.dist.dist_kernels import cheb_step
    dev = _card()
    n, h = 1000, 3
    pA = torch.zeros((3, n), device=dev)
    pC = torch.zeros((3, n), device=dev)
    xh = torch.zeros(n + 2 * h, device=dev)
    v = torch.zeros(n, device=dev)
    with pytest.raises(RuntimeError):      # a C offset crosses F = 1 blocks
        cheb_step((-3, 0, 3), pA, (-1, 0, 1), pC, xh, h, v, v, True, 1.0,
                  0.0, 1)
    with pytest.raises(ValueError):        # x_out overlaps x_h
        cheb_step((-3, 0, 3), pA, (-1, 0, 1), pC, xh, h, v, v, True, 1.0,
                  0.0, 2, x_out=xh[h:h + n])


def test_distributed_grid_solve_one_rank_nccl():
    """distributed_grid_solve at n=64 on a one-rank NCCL group: the JAX
    record (docs/sample_results/dist_scaling.txt, ndev 1) through K6 and
    K1's padded-x entry."""
    import torch.distributed as dist
    from tpuamg_torch import kernels
    from tpuamg_torch.dist import device_mesh, distributed_grid_solve
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    _card()
    n = 64
    p = Params(2.0, 3.0, 1e6)
    A, b, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    mesh = device_mesh()
    try:
        kernels.reset_launches()
        res, _ = distributed_grid_solve(A, b, (n + 1, n + 1), F=2,
                                        mesh=mesh, tol=1e-8, maxiter=120)
        counts = dict(kernels.LAUNCHES)
    finally:
        dist.destroy_process_group()
    info = res.dist_info
    assert res.converged and res.niters == 18, res.niters
    assert info["nflat"] == 15360 and info["outer_pallas"]
    assert info["pallas_levels"] == info["sharded_levels"] == 4
    for name in ("cheb_step", "dia_spmv_pad", "dia_residual_pad"):
        assert counts.get(name, 0) > 0, (name, counts)
    rel = np.linalg.norm(b - A.matvec(res.x)) / np.linalg.norm(b)
    assert rel < 1e-6, rel
