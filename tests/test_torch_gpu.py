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
    from tpuamg_torch.amg.grid_fused import (setup_grid_fused,
                                             vcycle_plain, vcycle_sequenced)
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
    z = vcycle_sequenced(vc, bm).clone()
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
# K2: the whole cycle as one persistent cooperative launch
# ---------------------------------------------------------------------------

# the launches of the host-sequenced cycle, none of which the one-launch
# cycle makes
SEQUENCED_STEPS = ("cheb_apply", "restrict", "prolong", "coarse_gemv",
                   "coarse_reduce", "dia_residual", "dia_spmv")


def _cycle_setup(dev, cycle, storage, gamma, pre=1, n=64):
    """The sequenced cycle test's hierarchy (n=64, coarse_dof 200, degree
    4: three smoothed levels), and a pre-masked random b."""
    from dataclasses import replace
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    from tpuamg_torch.amg.grid_fused import setup_grid_fused
    p = Params(2.0, 3.0, gamma)
    A, _, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type=cycle, coarse_dof=200, presmooth_iter=pre)
    vc, slots, nflat = setup_grid_fused(A, (n + 1, n + 1), F=2, params=prm,
                                        cheb_degree=4, storage_dtype=storage,
                                        device=dev)
    rng = np.random.default_rng(2)
    bm = torch.as_tensor(rng.standard_normal(nflat), dtype=torch.float32
                         ).to(dev) * vc.mask_flat
    return vc, bm


@pytest.mark.parametrize("cycle,storage,gamma,pre", [
    (c, s, g, 1) for c in ("v", "w") for s in (torch.float32, torch.bfloat16)
    for g in (1.0, 1e6)] + [("v", torch.float32, 1.0, 0),
                            ("w", torch.bfloat16, 1e6, 0)])
def test_cycle_kernel_matches_plain(cycle, storage, gamma, pre):
    """One launch of the persistent cycle against its plain version
    (run_program_plain of the same program) at the sequenced cycle
    test's limit, 1e-4 relative (float32 sums in another order); one
    cycle_persistent launch and none of the sequenced cycle's; pre = 0
    runs the ZERO op."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg import cycle_program as cp
    from tpuamg_torch.amg.grid_fused import vcycle
    dev = _card()
    vc, bm = _cycle_setup(dev, cycle, storage, gamma, pre)
    prog = vc.program()
    assert any(op.kind == cp.ZERO for op in prog.ops) == (pre == 0)
    kernels.reset_launches()
    z = vcycle(vc, bm).clone()
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"cycle_persistent": 1, "vcycle": 1}
    z_ref = cp.run_program_plain(prog, vc, bm).clone()
    assert bool(torch.isfinite(z).all())
    assert _rel(z, z_ref) < 1e-4, _rel(z, z_ref)


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_cycle_kernel_matches_sequenced(cycle):
    """The one-launch cycle against the earlier host-sequenced one, which
    launches its steps and no cycle_persistent."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid_fused import vcycle, vcycle_sequenced
    dev = _card()
    vc, bm = _cycle_setup(dev, cycle, torch.bfloat16, 1e6)
    kernels.reset_launches()
    z_s = vcycle_sequenced(vc, bm).clone()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cycle_persistent"] == 0
    assert kernels.LAUNCHES["cheb_apply"] > 0
    z = vcycle(vc, bm).clone()
    torch.cuda.synchronize()
    assert _rel(z, z_s) < 1e-4, _rel(z, z_s)


def test_cycle_kernel_is_deterministic():
    """No atomics: the same cycle gives the same bits run to run."""
    from tpuamg_torch.amg.grid_fused import vcycle
    dev = _card()
    vc, bm = _cycle_setup(dev, "w", torch.bfloat16, 1e6)
    outs = [vcycle(vc, bm).clone() for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_cycle_kernel_too_large_grid_raises():
    """A grid that cannot be co-resident is refused by the cooperative
    launch, and the wrapper raises naming the grid and the occupancy;
    nothing falls back to the sequenced cycle."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid_fused import (_cycle_persistent, cycle_grid,
                                             vcycle)
    dev = _card()
    vc, bm = _cycle_setup(dev, "v", torch.float32, 1.0, n=16)
    _, per_sm, sms = cycle_grid(vc)
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="resident blocks per SM"):
        _cycle_persistent(vc, bm, _grid=per_sm * sms + 1)
    assert not any(kernels.LAUNCHES.values())
    vcycle(vc, bm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cycle_persistent"] == 1


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_pcg_route_b_one_cycle_launch_per_iteration(cycle):
    """Route (b): krylov.cg.pcg with the cycle as M makes one
    cycle_persistent launch per outer SpMV (each iteration, and the
    start's), none of the sequenced cycle's steps, and converges as the
    same loop over the plain cycle does."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg import cycle_program as cp
    from tpuamg_torch.krylov import pcg
    dev = _card()
    fp, bk = _pcg_setup(dev, cycle)
    vc = fp.vc
    kernels.reset_launches()
    res = pcg(fp.Q, bk, M=vc, tol=1e-8, maxiter=100, chunk=8)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    assert res.converged
    assert counts["cycle_persistent"] == counts["vcycle"] \
        == counts["dia_spmv"] > 1, counts
    for name in SEQUENCED_STEPS[:-1]:
        assert counts.get(name, 0) == 0, (name, counts)
    ref = pcg(lambda v: fp.Q.matvec(v), bk, M=lambda r: cp.run_program_plain(
        vc.program(), vc, r * vc.mask_flat).clone(), tol=1e-8, maxiter=100,
        chunk=8)
    assert abs(res.niters - ref.niters) <= 1, (res.niters, ref.niters)


# ---------------------------------------------------------------------------
# K3: the Chebyshev sweep
# ---------------------------------------------------------------------------

def _cheb_inputs(dev, storage, n=98_306, F=2, seed=3):
    """A diagonally dominant random DIA over a 2D-grid-like offset set and
    its (2F-1)-offset block inverse, zero across node blocks of F rows, as
    the grid path builds them (n = 98,306 is no multiple of 32: a warp of
    the kernel runs past the last row)."""
    from tpuamg_torch.sparse.dia_kernels import _cheb_coefs
    rng = np.random.default_rng(seed)
    offsA = (-2 * 257 - 1, -2 * 257, -2, -1, 0, 1, 2, 2 * 257, 2 * 257 + 1)
    planes = rng.standard_normal((len(offsA), n)) * 0.1
    planes[offsA.index(0)] = 2.0 + rng.random(n)
    offsC = tuple(range(-(F - 1), F))
    cplanes = rng.standard_normal((len(offsC), n)) * 0.05
    cplanes[offsC.index(0)] += 0.5
    f = np.arange(n) % F
    for d, o in enumerate(offsC):
        cplanes[d][(f + o < 0) | (f + o >= F)] = 0.0
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


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_r", [False, True])
def test_cheb_sweep_sequenced_matches_plain(storage, want_r):
    """The earlier design of K3 (csrc/cheb.cu, two launches per step),
    kept for comparison on the card, against plain; it makes no launch of
    the one-launch kernel and leaves x unchanged."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (cheb_sweep_plain,
                                                 cheb_sweep_sequenced)
    dev = _card()
    offsA, pA, offsC, pC, x, b, theta, coefs = _cheb_inputs(dev, storage)
    kernels.reset_launches()
    for iters in (1, 2):
        xk, rk = cheb_sweep_sequenced(offsA, pA, offsC, pC, x, b, theta,
                                      coefs, 3, iters, want_r)
        torch.cuda.synchronize()
        xp, rp = cheb_sweep_plain(offsA, pA, offsC, pC, x, b, theta, coefs,
                                  3, iters, want_r)
        assert _rel(xk, xp) < 1e-5, iters
        assert rk is None if not want_r else _rel(rk, rp) < 1e-5
    assert dict(kernels.LAUNCHES) == {"cheb_sweep_sequenced": 2}
    assert torch.equal(x, _cheb_inputs(dev, storage)[4])


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_cheb_sweep_kernel_node_blocks_of_three(storage):
    """F = 3 does not divide a warp: each step is two ops of the one
    launch (RESIDUAL into t, then CHEB_APPLY), still one launch per
    application."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import cheb_sweep, cheb_sweep_plain
    dev = _card()
    offsA, pA, offsC, pC, x, b, theta, coefs = _cheb_inputs(
        dev, storage, n=98_307, F=3)
    assert offsC == (-2, -1, 0, 1, 2)
    kernels.reset_launches()
    for iters in (1, 2):
        for want_r in (False, True):
            xk, rk = cheb_sweep(offsA, pA, offsC, pC, x, b, theta, coefs, 3,
                                iters, want_r)
            torch.cuda.synchronize()
            xp, rp = cheb_sweep_plain(offsA, pA, offsC, pC, x, b, theta,
                                      coefs, 3, iters, want_r)
            assert _rel(xk, xp) < 1e-5, (iters, want_r)
            if want_r:
                assert _rel(rk, rp) < 1e-5, iters
    assert dict(kernels.LAUNCHES) == {"cheb_sweep": 4}


def _route_c_hierarchy(dev, n=64):
    """The route-(c) hierarchy (setup_grid, NL-AMLI(2), f32) at n."""
    from dataclasses import replace
    from tpuamg_torch.amg.grid import setup_grid
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, 1e6)
    A, _, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    prm = replace(PRESETS["metric_schwarz"], cycle_type="nl_amli",
                  amli_degree=2, dtype="float32")
    prec, slots, nd = setup_grid(A, (n + 1, n + 1), F=2, params=prm,
                                 dtype=torch.float32, device=dev)
    return prec, nd


def test_cheb_sweep_kernel_every_level():
    """Every level of the route-(c) hierarchy: smooth and smooth_residual,
    iters 1 and 2, against the plain sweep, one launch each; the old
    design's launches none.  Limit: 1e-5, or twice the f32 floor where
    that is larger: the plain sweep's own distance from the same sweep in
    float64.  On the coarsest levels (578 and 162 rows) the smoothed x is
    4-6 times smaller than the random x, and that floor passes 1e-5
    (1.6e-5 and 3.1e-5 on the CPU; reversing the plain sweep's diagonal
    order alone moves it by up to 3.8e-5)."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (FusedChebSmoother,
                                                 cheb_sweep_plain)
    dev = _card()
    prec, _ = _route_c_hierarchy(dev)
    rng = np.random.default_rng(8)
    assert len(prec.levels) >= 3
    for lv, L in enumerate(prec.levels):
        sm = L.smoother
        assert isinstance(sm, FusedChebSmoother) and sm.F == 2
        x = torch.as_tensor(rng.standard_normal(sm.n), dtype=torch.float32
                            ).to(dev)
        b = torch.as_tensor(rng.standard_normal(sm.n), dtype=torch.float32
                            ).to(dev)
        for iters in (1, 2):
            kernels.reset_launches()
            xs, r = sm.smooth_residual(None, x, b, iters)
            x2 = sm.smooth(None, x, b, iters)
            torch.cuda.synchronize()
            assert dict(kernels.LAUNCHES) == {"cheb_sweep": 2}, lv
            xp, rp = cheb_sweep_plain(sm.offsA, sm.planesA, sm.offsC,
                                      sm.planesC, x, b, sm.theta, sm.coefs,
                                      sm.degree, iters, True)
            x64, r64 = cheb_sweep_plain(
                sm.offsA, sm.planesA.double(), sm.offsC,
                sm.planesC.double(), x.double(), b.double(), sm.theta,
                sm.coefs, sm.degree, iters, True)
            lim_x = max(1e-5, 2 * _rel(xp, x64))
            lim_r = max(1e-5, 2 * _rel(rp, r64))
            errs = [_rel(got, ref) for got, ref in ((xs, xp), (x2, xp),
                                                    (r, rp))]
            assert max(errs[:2]) <= lim_x and errs[2] <= lim_r, (
                lv, sm.n, iters, errs, lim_x, lim_r)


def test_cheb_sweep_kernel_is_deterministic():
    """No atomics: the same application gives the same bits run to run."""
    dev = _card()
    prec, _ = _route_c_hierarchy(dev)
    sm = prec.levels[0].smoother
    rng = np.random.default_rng(9)
    x, b = (torch.as_tensor(rng.standard_normal(sm.n), dtype=torch.float32
                            ).to(dev) for _ in range(2))
    outs = [sm.smooth_residual(None, x, b, 2) for _ in range(3)]
    torch.cuda.synchronize()
    for xo, ro in outs[1:]:
        assert torch.equal(xo, outs[0][0]) and torch.equal(ro, outs[0][1])


def test_cheb_sweep_kernel_too_large_grid_raises():
    """A grid that cannot be co-resident is refused by the cooperative
    launch, and the wrapper raises naming the grid and the occupancy;
    nothing falls back to the sequenced sweep."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.cycle_program import SweepProgram
    from tpuamg_torch.amg.grid_fused import _persistent_occupancy
    from tpuamg_torch.sparse.dia_kernels import _cheb_persistent
    dev = _card()
    offsA, pA, offsC, pC, x, b, theta, coefs = _cheb_inputs(
        dev, torch.float32, n=4096)
    prog = SweepProgram(offsA, pA, offsC, pC, 4096, 2, theta, coefs, 3)
    per_sm, sms = _persistent_occupancy(
        "cheb", 0, prog.shared_bytes(1, True), torch.cuda.current_device())
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="resident blocks per SM"):
        _cheb_persistent(prog, x, b, 1, True, _grid=per_sm * sms + 1)
    assert not any(kernels.LAUNCHES.values())
    _cheb_persistent(prog, x, b, 1, True)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"cheb_sweep": 1}


def test_nl_amli_one_launch_per_smoother_application():
    """Inside an NL-AMLI MGPreconditioner.matvec every smoother
    application is one launch of the one-launch K3, none of the
    sequenced one, and the cycle agrees with the same cycle over the
    plain sweep (rel 1e-3: the AMLI steps are nonlinear in z, so f32
    rounding differences of the sweeps grow through the recursion)."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import cheb_sweep_plain
    dev = _card()
    prec, nd = _route_c_hierarchy(dev)
    apps = []
    for L in prec.levels:
        real = L.smoother._sweep

        def counted(x, b, iters, want_r, real=real):
            apps.append(want_r)
            return real(x, b, iters, want_r)
        L.smoother._sweep = counted
    b = torch.as_tensor(np.random.default_rng(10).standard_normal(nd),
                        dtype=torch.float32).to(dev)
    kernels.reset_launches()
    z = prec.matvec(b)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    assert len(apps) > len(prec.levels) and any(apps) and not all(apps)
    assert counts.get("cheb_sweep") == len(apps), counts
    assert not counts.get("cheb_sweep_sequenced"), counts
    for L in prec.levels:
        sm = L.smoother

        def plain(x, b, iters, want_r, sm=sm):
            return cheb_sweep_plain(sm.offsA, sm.planesA, sm.offsC,
                                    sm.planesC, x, b, sm.theta, sm.coefs,
                                    sm.degree, iters, want_r)
        sm._sweep = plain
    z_p = prec.matvec(b)
    assert torch.isfinite(z).all()
    assert _rel(z, z_p) < 1e-3, _rel(z, z_p)


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
    of a cycle runs (RESIDUAL and CHEB_APPLY belong to K3's sweep
    programs only); pre-smoothing 1 has cold steps, 0 the ZERO op."""
    from tpuamg_torch.amg import cycle_program as cp
    from tpuamg_torch.amg.grid_fused import pcg_chunk, pcg_chunk_plain
    dev = _card()
    fp, bk = _pcg_setup(dev, cycle, n=16, gamma=1.0, storage=storage,
                        coarse_dof=20, presmooth_iter=pre)
    assert len(fp.vc.spec.levels) == 3
    prog = fp.program()
    kinds = {cp.OP_NAMES[op.kind] for op in prog.ops}
    assert kinds == set(cp.OP_NAMES) - {"ZERO" if pre else "",
                                         "RESIDUAL", "CHEB_APPLY"}
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
    assert got.executed == got.niters               # no chunk runs past
    np.testing.assert_allclose(got.residuals[:2], ref.residuals[:2],
                               rtol=1e-4)
    np.testing.assert_allclose(got.alphas[:2], ref.alphas[:2], rtol=1e-4)


def _stop_between(rows, kind, at):
    """A stop test of `kind` that row `at` meets and row at - 1 does not:
    the threshold halfway (geometrically) between their tested values,
    so f32 noise between two chunks cannot move the crossing."""
    def tested(row):
        if kind == 2:
            return row[2]
        if kind == 1:
            return row[3]
        return row[3] / max(row[4], 1e-300)
    a, b = tested(rows[at - 1]), tested(rows[at])
    assert b < a, (kind, a, b)
    mid = float(np.sqrt(a * b))
    return (kind, 0.0, mid) if kind == 3 else (kind, mid, 0.0)


@pytest.mark.parametrize("kind", [1, 2, 3])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_pcg_chunk_kernel_stops_at_the_crossing(cycle, kind):
    """K5 given a stop test leaves the chunk at the crossing, as the plain
    chunk does: the same iterations run and reason in the carry row, the
    rows up to the crossing, x, and a second chunk that continues from
    either (p from the buffer a whole chunk ends in, rz carried)."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid_fused import pcg_chunk, pcg_chunk_plain
    dev = _card()
    fp, bk = _pcg_setup(dev, cycle, gamma=1.0)
    start = _chunk_start(fp, bk)
    chunk, at = 12, 4
    whole = pcg_chunk_plain(fp, *start(), chunk)[4].double().cpu().numpy()
    stop = _stop_between(whole[:, :5], kind, at)
    kernels.reset_launches()
    got = _clone_all(pcg_chunk(fp, *start(), chunk, stop))
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"pcg_chunk": 1}
    ref = _clone_all(pcg_chunk_plain(fp, *start(), chunk, stop))
    st, stp = (t.double().cpu().numpy() for t in (got[4], ref[4]))
    assert tuple(stp[chunk, 2:4]) == (at + 1, 1)
    assert tuple(st[chunk, 2:4]) == (at + 1, 1)
    assert np.all(st[at + 1:chunk] == 0)
    np.testing.assert_allclose(st[:at + 1, :5], stp[:at + 1, :5], rtol=1e-3)
    _check_chunks(got, ref, chunk)
    # a second chunk from each state, whole
    x, r, p, z, s1 = got
    xp, rp, pp, zp, s1p = ref
    nxt = pcg_chunk(fp, x.clone(), r.clone(), p.clone(), z.clone(),
                    s1[chunk, 1:2].clone(), 3)[4].double().cpu().numpy()
    nxtp = pcg_chunk_plain(fp, xp.clone(), rp.clone(), pp.clone(),
                           zp.clone(), s1p[chunk, 1:2].clone(), 3)[4]
    np.testing.assert_allclose(nxt[:3, :5],
                               nxtp[:3, :5].double().cpu().numpy(),
                               rtol=1e-3)


def test_pcg_fused_kernel_stops_at_the_crossing():
    """pcg_fused through K5 counts what the plain chunk counts, runs one
    cycle per counted iteration (plus z0's) and returns the crossing
    iterate, for each stop type."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.grid_fused import pcg_fused, pcg_chunk_plain
    dev = _card()
    fp, bk = _pcg_setup(dev, "w", gamma=1.0)
    for kind in (1, 2, 3):
        run_kernel = fp.run_chunk
        fp.run_chunk = lambda *a: pcg_chunk_plain(fp, *a)
        ref = pcg_fused(fp, bk, tol=2e-5, maxiter=60, chunk=32,
                        stop_type=kind)
        fp.run_chunk = run_kernel
        kernels.reset_launches()
        got = pcg_fused(fp, bk, tol=2e-5, maxiter=60, chunk=32,
                        stop_type=kind)
        torch.cuda.synchronize()
        assert got.converged and ref.converged
        assert abs(got.niters - ref.niters) <= 1, (kind, got.niters,
                                                   ref.niters)
        assert got.executed == got.niters
        assert kernels.LAUNCHES["pcg_chunk"] == 1
        assert kernels.LAUNCHES["vcycle"] == 1          # z0 only
        assert _rel(got.x, ref.x) < 1e-3


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


# ---------------------------------------------------------------------------
# the algebraic metric-AMG path (torch ops; no hand-written kernel): the
# card against the CPU on the same hierarchy, float64
# ---------------------------------------------------------------------------

def _algebraic(n=32, gamma=1e6):
    from tpuamg_torch.amg.hierarchy import setup_amg
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    dev = _card()
    p = Params(2.0, 3.0, gamma)
    A, b, sizes, _ = get_system(get_mesh(n, 2),
                                mms.setup_bidomain_mms(p, 2), p)
    idofs = np.arange(sizes[0], A.shape[0])
    prec = setup_amg(A, PRESETS["metric_schwarz"], idofs=idofs, device=dev)
    return dev, A, b, sizes, idofs, prec, prec.to("cpu")


def _rel(a, b):
    a, b = a.cpu().double(), b.cpu().double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_native_library_loads_on_the_card():
    from tpuamg_torch import native
    _card()
    assert native.get_lib() is not None
    assert native.library_path().is_file()


@pytest.mark.parametrize("what", ["ell", "gs", "schwarz", "metric",
                                  "cycle"])
def test_algebraic_on_card_matches_cpu(what):
    dev, A, b, _, _, prec, cpu = _algebraic()
    rng = np.random.default_rng(3)
    L, Lc = prec.levels[0], cpu.levels[0]
    n = L.A.shape[0]
    x = torch.as_tensor(rng.standard_normal(n))
    bb = torch.as_tensor(rng.standard_normal(n))
    xd, bd = x.to(dev), bb.to(dev)
    got, ref = {
        "ell": lambda: (L.A.matvec(xd), Lc.A.matvec(x)),
        "gs": lambda: (L.smoother.gs.smooth(L.A, xd, bd, iters=2),
                       Lc.smoother.gs.smooth(Lc.A, x, bb, iters=2)),
        "schwarz": lambda: (L.smoother.schwarz.smooth(L.A, xd, bd),
                            Lc.smoother.schwarz.smooth(Lc.A, x, bb)),
        "metric": lambda: (L.smoother.smooth(L.A, xd, bd, reverse=True),
                           Lc.smoother.smooth(Lc.A, x, bb, reverse=True)),
        "cycle": lambda: (prec.matvec(xd), cpu.matvec(x)),
    }[what]()
    assert got.device.type == "cuda"
    assert _rel(got, ref) <= 1e-12, _rel(got, ref)


@pytest.mark.parametrize("precond,method", [
    ("metric_mono", "cg"), ("hazmath", "cg"), ("hazmath_Schwarz", "cg"),
    ("diag", "cg"), ("metric_mono", "minres"), ("metric_mono", "gmres")])
def test_algebraic_solve_on_card_matches_cpu(precond, method):
    """The card's solve against the CPU's: equal iterations, and x (the
    crossing iterate) to 1e-8, or to 5e-7 for hazmath, whose
    43-iteration CG at tol 1e-8 moves its crossing iterate by 1.7e-8 ..
    1.1e-7 under one unit of rounding in each product of A and M
    (scripts/torch_rounding_floor.py bidomain hazmath, CPU and card); the
    card differs from the CPU in summation order.  For hazmath the iterate at the end
    of the crossing's 32-iteration chunk (an uncut run, tol 0) is held
    to 1e-8 too."""
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.problems.solve import solve_system
    from tpuamg_torch.sparse.host import extract_diag_blocks
    dev, A, b, sizes, idofs, _, _ = _algebraic(n=16)
    kw = dict(idofs=idofs, tol=1e-8, maxiter=500, method=method,
              params=PRESETS["metric_schwarz"] if precond == "metric_mono"
              else None,
              blocks=extract_diag_blocks(A, sizes) if precond == "diag"
              else None)
    got = solve_system(A, b, precond, sizes, device=dev, **kw)
    ref = solve_system(A, b, precond, sizes, device="cpu", **kw)
    err = np.abs(got.x - ref.x).max() / np.abs(ref.x).max()
    assert got.converged
    if precond == "diag":
        # exact blocks, not gamma-robust: ~170 iterations at cond 8e4,
        # where the card's other summation order moves the count, and
        # two solves to 1e-8 may differ by up to cond * tol ~ 8e-4 in x
        assert abs(got.niters - ref.niters) <= 5, (got.niters, ref.niters)
        assert err <= 1e-4, err
    else:
        assert got.niters == ref.niters, (got.niters, ref.niters)
        assert err <= (5e-7 if precond == "hazmath" else 1e-8), err
    if precond == "hazmath":
        kw.update(tol=0.0, maxiter=-(-ref.niters // 32) * 32)
        got = solve_system(A, b, precond, sizes, device=dev, **kw)
        ref = solve_system(A, b, precond, sizes, device="cpu", **kw)
        assert got.niters == ref.niters == kw["maxiter"]
        err = np.abs(got.x - ref.x).max() / np.abs(ref.x).max()
        assert err <= 1e-8, err


# ---------------------------------------------------------------------------
# The 3D-1D pipeline: dump -> run_solver_3d1d on the card -> solution.txt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", ["1", "100000000"])
def test_3d1d_pipeline_on_card_matches_cpu(tmp_path, gamma):
    """mesh_n 8, radius 0.2, the default synthetic neuron and
    input_metric.dat (CG, stop type 1, tol 1e-6): the card's solve
    against the CPU's on the same dump, both on the algebraic route.  x to 1e-10 at gamma 1 and 1e-8
    at gamma 1e8: there one unit of rounding in each product of A and M
    moves x by 3.3e-10 .. 1.1e-9 on the CPU (cond(A) 1.6e9;
    scripts/torch_rounding_floor.py 3d1d 8), and the card differs from
    the CPU in summation order."""
    from tpuamg_torch.io_utils import load_system, read_solution
    from tpuamg_torch.problems import emi_3d1d, run_solver_3d1d
    dev = _card()
    d, o, oc = (str(tmp_path / k) + "/" for k in ("d", "o", "oc"))
    assert emi_3d1d.main(["-gamma", gamma, "-radius", "0.2", "-dump", "1",
                          "-outdir", d, "-mesh_n", "8"]) == 0
    alg = ["-route", "algebraic"]      # the card's default is structured
    got = run_solver_3d1d.main(["-indir", d, "-outdir", o] + alg,
                               device=dev)
    ref = run_solver_3d1d.main(["-indir", d, "-outdir", oc] + alg,
                               device="cpu")
    assert got.converged and ref.converged
    assert got.niters == ref.niters <= 25, (got.niters, ref.niters)
    assert got.executed <= got.niters + 1
    err = np.abs(got.x - ref.x).max() / np.abs(ref.x).max()
    assert err <= (1e-10 if gamma == "1" else 1e-8), err
    A, b, _, _ = load_system(d)
    x = read_solution(o)
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) <= 1e-6


# ---------------------------------------------------------------------------
# K1's wide entry and the structured 3D-1D route
# ---------------------------------------------------------------------------

def _wide_offsets(nd, n, seed):
    """nd distinct sorted offsets: 0, +-(n + 5) (rows that read nothing)
    and the rest drawn from +-max(3n/2, nd)."""
    rng = np.random.default_rng(seed)
    r = max(3 * n // 2, nd)
    rest = np.setdiff1d(np.arange(-r, r + 1), [0, n + 5, -n - 5])
    offs = np.concatenate([[0, n + 5, -n - 5],
                           rng.choice(rest, nd - 3, replace=False)])
    return tuple(int(o) for o in np.sort(offs))


@pytest.mark.parametrize("nd", [65, 200, 1024, 3000])
@pytest.mark.parametrize("n", [1000, 50_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_dia_wide_entry_matches_plain(nd, n, dtype, residual):
    """More than kernels.MAX_DIAGS bands: K1's wide entry (the tile walk,
    csrc/dia_tiles.cu) against dia_spmv_plain, offsets beyond +-n
    included, at 1e-5 relative (float32 fma against separate products and
    sums), and bit for bit against the planes design (dia_wide_kernel: the
    same fmaf chain per row, less the exact zeros); one wide launch per
    call, the layout built once."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (KernelDIA, dia_spmv_plain,
                                                 dia_spmv_wide_planes)
    dev = _card()
    offs = _wide_offsets(nd, n, nd + n)
    assert len(offs) == nd and max(abs(o) for o in offs) > n
    planes = _random_planes(n, nd, dtype, 3).to(dev)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(dev)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32
                        ).to(dev) if residual else None
    op = KernelDIA(offs, planes, (n, n), 0)
    kernels.reset_launches()
    y = op.residual(x, b) if residual else op.matvec(x)
    torch.cuda.synchronize()
    ref = dia_spmv_plain(offs, planes, x, b)
    err = float((y - ref).abs().max() / ref.abs().max())
    assert err < 1e-5, err
    name = "dia_residual_wide" if residual else "dia_spmv_wide"
    assert dict(kernels.LAUNCHES) == {name: 1, "dia_tiles_build": 1}
    tiles = op.tiles()
    assert tiles.device.type == "cuda"
    y2 = op.residual(x, b) if residual else op.matvec(x)
    assert op.tiles() is tiles                 # built once
    assert dict(kernels.LAUNCHES) == {name: 2, "dia_tiles_build": 1}
    y_old = dia_spmv_wide_planes(offs, planes, x, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name + "_planes"] == 1
    assert torch.equal(y, y_old) and torch.equal(y2, y)


@pytest.mark.parametrize("nd,idx_dtype", [(256, torch.uint8),
                                          (257, torch.int16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_wide_entry_index_width(nd, idx_dtype, dtype):
    """Every tile of a dense band of nd offsets around 0 has nd bands: 256
    take uint8 local indices, 257 uint16 (an int16 tensor); the layout
    built on the card equals the one built on the CPU, and the kernel
    equals the planes design bit for bit either way."""
    from tpuamg_torch.sparse.dia_kernels import (KernelDIA, dia_spmv_plain,
                                                 dia_spmv_wide_planes)
    from tpuamg_torch.sparse.dia_tiles import build_tiles
    dev = _card()
    n = 4_000
    offs = tuple(range(-128, nd - 128))
    planes = _random_planes(n, nd, dtype, 8).to(dev)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(n),
                        dtype=torch.float32).to(dev)
    op = KernelDIA(offs, planes, (n, n), 0)
    y = op.matvec(x)
    tiles = op.tiles()
    assert tiles.idx.dtype == idx_dtype and tiles.max_bands == nd
    host = build_tiles(offs, planes.cpu())
    for k in ("vals", "idx", "ent_ptr", "band_ptr", "tile_off"):
        assert torch.equal(getattr(tiles, k).cpu(), getattr(host, k)), k
    assert torch.equal(y, dia_spmv_wide_planes(offs, planes, x))
    ref = dia_spmv_plain(offs, planes, x)
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-5


def test_dia_wide_entry_follows_the_planes():
    """The layout is built from the planes the kernel is handed: a write
    into KernelDIA.planes builds it again (counted), and the result is
    the new operator's; a bare dia_spmv call builds one for the call."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import (KernelDIA, dia_spmv,
                                                 dia_spmv_plain)
    dev = _card()
    n, offs = 3_000, _wide_offsets(100, 3_000, 11)
    planes = _random_planes(n, 100, torch.float32, 12).to(dev)
    x = torch.as_tensor(np.random.default_rng(13).standard_normal(n),
                        dtype=torch.float32).to(dev)
    op = KernelDIA(offs, planes, (n, n), 0)
    kernels.reset_launches()
    op.matvec(x)
    planes[:, ::2] = 0.0
    y = op.matvec(x)
    assert kernels.LAUNCHES["dia_tiles_build"] == 2
    ref = dia_spmv_plain(offs, planes, x)
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-5
    kernels.reset_launches()
    y_bare = dia_spmv(offs, planes, x)
    assert dict(kernels.LAUNCHES) == {"dia_spmv_wide": 1,
                                      "dia_tiles_build": 1}
    assert torch.equal(y_bare, y)


def test_dia_64_bands_take_the_narrow_entry():
    """64 bands: the <=64 entry (offsets by value), no wide launch and no
    layout."""
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse.dia_kernels import KernelDIA, dia_spmv_plain
    dev = _card()
    n, offs = 20_000, tuple(range(-32, 32))
    planes = _random_planes(n, 64, torch.float32, 5).to(dev)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(n),
                        dtype=torch.float32).to(dev)
    op = KernelDIA(offs, planes, (n, n), 0)
    kernels.reset_launches()
    y = op.matvec(x)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"dia_spmv": 1}
    assert op.tiles() is None
    ref = dia_spmv_plain(offs, planes, x)
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-5


def test_dia_wide_entry_rejects_bad_input():
    from tpuamg_torch.sparse.dia_kernels import (dia_spmv,
                                                 dia_spmv_wide_planes,
                                                 offsets_tensor)
    from tpuamg_torch.sparse.dia_tiles import build_tiles, dia_spmv_tiles
    dev = _card()
    offs = tuple(range(-40, 40))
    planes = torch.zeros((80, 100), device=dev)
    planes[40] = 1.0
    x = torch.zeros(100, device=dev)
    with pytest.raises(TypeError):
        dia_spmv(offs, planes, x.double())
    with pytest.raises(ValueError):
        dia_spmv(offs, planes, x, x_pad=2)
    with pytest.raises(ValueError):
        dia_spmv(offs, planes[:, :50], x)
    tiles = build_tiles(offs, planes)
    with pytest.raises(ValueError):
        dia_spmv_tiles(tiles, x[:50])
    with pytest.raises(ValueError):
        dia_spmv_tiles(tiles, x, out=x)
    with pytest.raises(ValueError):
        dia_spmv_tiles(tiles, x, x[:99])
    with pytest.raises(ValueError):
        dia_spmv_wide_planes(offs, planes, x,
                             offsets_dev=offsets_tensor(offs[:-1], dev))


def test_structured_level_k3_matches_plain():
    """The bidomain 2D system (n=63, gamma 1e6) on the structured
    hierarchy (structured_coords, no interface footprint, float32): every
    window level whose A and C have at most kernels.MAX_DIAGS bands takes
    FusedChebSmoother (K3, one launch per application), the others
    DiaChebyshevSmoother over KernelDIA; each K3 level's smooth_residual
    against cheb_sweep_plain at the phase-7 limit (1e-5, or twice the
    plain float32 sweep's own distance from float64)."""
    from tpuamg_torch import kernels
    from tpuamg_torch.amg.structured import (DiaChebyshevSmoother,
                                             setup_structured)
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    from tpuamg_torch.sparse.dia_kernels import (FusedChebSmoother,
                                                 cheb_sweep_plain)
    dev = _card()
    p = Params(2.0, 3.0, 1e6)
    mesh = get_mesh(63, 2)      # 64 x 64 vertices: Morton rank = code
    A, _, _, _ = get_system(mesh, mms.setup_bidomain_mms(p, 2), p)
    coords = np.concatenate([mesh.vertices, mesh.vertices])
    from dataclasses import replace
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type="v", coarse_dof=200)
    prec, _, _ = setup_structured(A, coords, prm, dtype=torch.float32,
                                  device=dev)
    k3 = 0
    rng = np.random.default_rng(7)
    for L in prec.levels:
        sm = L.smoother
        wide = len(L.A.offsets) > kernels.MAX_DIAGS
        assert isinstance(sm, DiaChebyshevSmoother if wide
                          else FusedChebSmoother)
        if wide:
            continue
        k3 += 1
        n = L.A.shape[0]
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev) * L.mask
        b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev) * L.mask
        before = kernels.LAUNCHES["cheb_sweep"]
        xk, rk = sm.smooth_residual(L.A, x, b, 1)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["cheb_sweep"] == before + 1
        xp, rp = cheb_sweep_plain(sm.offsA, sm.planesA, sm.offsC,
                                  sm.planesC, x, b, sm.theta, sm.coefs,
                                  sm.degree, 1, True)
        x64, _ = cheb_sweep_plain(
            sm.offsA, sm.planesA.double(), sm.offsC, sm.planesC.double(),
            x.double(), b.double(), sm.theta, sm.coefs, sm.degree, 1, True)
        floor = float(torch.linalg.vector_norm(xp.double() - x64)
                      / torch.linalg.vector_norm(x64))
        err = float(torch.linalg.vector_norm(xk - xp)
                    / torch.linalg.vector_norm(xp))
        assert err <= max(1e-5, 2 * floor), (n, err, floor)
    assert k3 > 0


def test_structured_3d1d_on_card_matches_cpu(tmp_path):
    """run_solver_3d1d's structured route (the card's default with
    coords.npy: float32 storage, float64 Krylov, the factored outer
    operator with AD through K1, refine=3, the host tail) at mesh_n 8,
    gamma 1e8, on the card against the same keywords on the CPU:
    iterations within 1 per refine pass, true residual <= 1e-6; K1 ran
    on the outer operator."""
    from tpuamg_torch import kernels
    from tpuamg_torch.io_utils import load_system, read_solution
    from tpuamg_torch.problems import emi_3d1d, run_solver_3d1d
    dev = _card()
    d, o, oc = (str(tmp_path / k) + "/" for k in ("d", "o", "oc"))
    assert emi_3d1d.main(["-gamma", "100000000", "-radius", "0.2", "-dump",
                          "1", "-outdir", d, "-mesh_n", "8"]) == 0
    kernels.reset_launches()
    got = run_solver_3d1d.main(["-indir", d, "-outdir", o], device=dev)
    launches = dict(kernels.LAUNCHES)
    ref = run_solver_3d1d.main(["-indir", d, "-outdir", oc, "-route",
                                "structured"], device="cpu")
    assert got.route == ref.route == "structured"
    assert got.converged and ref.converged
    assert len(got.pass_iters) == len(ref.pass_iters)
    assert all(abs(a - c) <= 1 for a, c in zip(got.pass_iters,
                                                ref.pass_iters))
    assert launches.get("dia_spmv", 0) + launches.get("dia_spmv_wide", 0) \
        > 0, launches
    # the wide launches are the tile walk's, on layouts built once each
    assert not launches.get("dia_spmv_wide_planes") and not launches.get(
        "dia_residual_wide_planes"), launches
    if launches.get("dia_spmv_wide"):
        assert 0 < launches["dia_tiles_build"] <= 4, launches
    A, b, _, _ = load_system(d)
    x = read_solution(o)
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) <= 1e-6
