"""The one-launch cycle of tpuamg_torch (grid_fused.vcycle): its plain
version, the op program's run_program_plain, against the JAX package's
_mega_kernel, and the host side of the launch.

* run_program_plain(vc.program(), ...) against the JAX FusedVCycle.matvec
  in interpret mode, on the JAX package's own hierarchy (the same planes
  and T): the bench path's settings cut to n=16 (V-cycle, Chebyshev
  degree 4, bf16 storage, F=2, a coarse inverse T of 5 rows), and a
  W-cycle in f32.  Each JAX cycle runs once, in a module fixture.
* One program per cycle: FusedPCG's program is its vc's.
* vcycle on a CPU tensor is run_program_plain, bit for bit.
* pcg_chunk_sequenced keeps the earlier design: its cycle is
  vcycle_sequenced.
* The launch's argument vector, its refusals and its launch count, with
  the library replaced by a recorder (no card here).
"""
import functools
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuamg_torch import kernels, state
from tpuamg_torch.amg import cycle_program as cp
from tpuamg_torch.amg import grid_fused
from tpuamg_torch.amg.grid_fused import (FusedPCG, setup_grid_fused_pcg,
                                         vcycle, vcycle_plain)
from tpuamg_torch.config import PRESETS
from tpuamg_torch.fem import mms
from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system

N = 16
# (cycle, storage, gamma, Chebyshev degree, coarse_dof) of each JAX cycle
JAX_CASES = {
    "v-bf16": ("v", "bfloat16", 1e6, 4, 60),
    # the f32 twin of v-bf16: the JAX bf16 cycle's own distance from it
    # sets the bf16 limit
    "v-f32": ("v", None, 1e6, 4, 60),
    "w-f32": ("w", None, 1.0, 4, 60),
}


@functools.lru_cache(maxsize=None)
def _system(gamma):
    p = Params(2.0, 3.0, gamma)
    A, b, _, _ = get_system(get_mesh(N, 2), mms.setup_bidomain_mms(p, 2), p)
    return A, b


@pytest.fixture(scope="module")
def jax_cycles():
    """{case: (the JAX z in canonical order, the port's FusedVCycle on the
    JAX hierarchy, slots, r)}; one JAX matvec per case, interpret mode."""
    from tpuamg.amg.grid_fused import setup_grid_fused as jax_setup
    out = {}
    for case, (cycle, storage, gamma, degree, coarse) in JAX_CASES.items():
        A, _ = _system(gamma)
        prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                      cycle_type=cycle, coarse_dof=coarse)
        vc, slots, nflat = jax_setup(
            A, (N + 1, N + 1), F=2, params=prm, cheb_degree=degree,
            storage_dtype=storage and getattr(jnp, storage),
            interpret=True)
        r = np.random.default_rng(3).standard_normal(A.shape[0])
        bj = jnp.zeros(nflat, jnp.float32).at[jnp.asarray(slots)].set(
            jnp.asarray(r, jnp.float32))
        z = np.asarray(vc.matvec(bj)).astype(np.float64)[slots]
        out[case] = (z, state.vcycle_from_jax(vc, 2, device="cpu"), slots,
                     r)
    return out


def _program_z(tv, slots, r):
    bk = torch.zeros(tv.nflat)
    bk[torch.as_tensor(slots)] = torch.as_tensor(r, dtype=torch.float32)
    z = cp.run_program_plain(tv.program(), tv, bk * tv.mask_flat)
    return z.double().numpy()[slots]


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_program_matches_jax_mega_kernel_bf16_v(jax_cycles):
    """The bench path's cycle at n=16.  The port and the JAX kernel round
    bf16 products at other places, so the limit is twice the JAX bf16
    cycle's own distance from its f32 twin on the same system: the
    storage's own rounding, which no tolerance below it could tell from
    a fault."""
    z_j, tv, slots, r = jax_cycles["v-bf16"]
    z_j32 = jax_cycles["v-f32"][0]
    spec = tv.spec
    assert spec.cycle == "v" and spec.F == 2 and spec.rows_c == 5
    assert {S.degree for S in spec.levels} == {4}
    assert tv.T.dtype == tv.A_planes[0].dtype == torch.bfloat16
    storage_noise = _rel(z_j, z_j32)
    assert storage_noise > 0
    err = _rel(_program_z(tv, slots, r), z_j)
    assert err <= 2 * storage_noise, (err, storage_noise)


def test_program_matches_jax_mega_kernel_f32_w(jax_cycles):
    """A W-cycle (warm second visits) in f32 against _mega_kernel at
    tests/test_torch_grid_fused.py's limit for f32 cycles, 2e-5."""
    z_j, tv, slots, r = jax_cycles["w-f32"]
    assert tv.spec.cycle == "w" and tv.T.dtype == torch.float32
    assert sum(op.kind == cp.RESID_RESTRICT
               for op in tv.program().ops) == 3      # levels 0, 1, 1
    err = _rel(_program_z(tv, slots, r), z_j)
    assert err < 2e-5, err


def _fused(cycle="v", storage=None, pre=1, gamma=1e6):
    """n=16 fused PCG runner with three smoothed levels (coarse_dof 20)."""
    A, b = _system(gamma)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type=cycle, coarse_dof=20, presmooth_iter=pre)
    fp, slots, nflat = setup_grid_fused_pcg(
        A, (N + 1, N + 1), F=2, params=prm, storage_dtype=storage,
        device="cpu")
    return fp


def _rhs(vc, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(vc.nflat),
                           dtype=torch.float32) * vc.mask_flat


def test_fused_pcg_program_is_vc_program():
    """One vc owns one op table and one set of second x buffers, whichever
    kernel runs them."""
    fp = _fused()
    vc = fp.vc
    prog = vc.program()
    assert fp.program() is prog and vc.program() is prog
    assert FusedPCG(vc, fp.Q).program() is prog
    z = vcycle(vc, _rhs(vc))
    assert vc.program() is prog and z.data_ptr() == vc._x[0].data_ptr()


@pytest.mark.parametrize("pre", [1, 0])
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_vcycle_cpu_is_run_program_plain_bitwise(cycle, storage, pre):
    """On a CPU tensor vcycle runs the plain version of the one-launch
    kernel, and launches nothing; it equals vcycle_plain bit for bit."""
    vc = _fused(cycle, storage, pre).vc
    bm = _rhs(vc, 1)
    kernels.reset_launches()
    z = vcycle(vc, bm).clone()
    assert not any(kernels.LAUNCHES.values())
    assert torch.equal(z, cp.run_program_plain(vc.program(), vc, bm))
    assert torch.equal(z, vcycle_plain(vc, bm))
    assert torch.equal(vc.matvec(bm), z)
    assert float(torch.linalg.vector_norm(z)) > 0


def test_pcg_chunk_sequenced_cycles_through_vcycle_sequenced(monkeypatch):
    """The earlier chunk stays what it was: its cycle is the host-sequenced
    one, once per iteration on r, never the one-launch vcycle.  The
    chunk's own launches go to a recorder (no card here)."""
    fp = _fused("w")
    vc = fp.vc
    calls = []

    class _Lib:
        def __getattr__(self, name):
            calls.append(name)
            return lambda *a: 0
    monkeypatch.setattr(kernels, "_lib", _Lib())
    monkeypatch.setattr(kernels, "require", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda: 0)
    cycles = []
    monkeypatch.setattr(grid_fused, "vcycle_sequenced",
                        lambda v, r: cycles.append((v, r)))

    def no_vcycle(*a):
        raise AssertionError("pcg_chunk_sequenced called vcycle")
    monkeypatch.setattr(grid_fused, "vcycle", no_vcycle)
    bm = _rhs(vc, 2)
    x, r, p, z = (torch.zeros_like(bm), bm.clone(), torch.zeros_like(bm),
                  bm.clone())
    grid_fused.pcg_chunk_sequenced(fp, x, r, p, z, torch.tensor([-1.0]), 3)
    assert [v for v, _ in cycles] == [vc] * 3
    assert all(rr is r for _, rr in cycles)
    assert calls.count("tpuamg_pcg_pq") == 3
    assert not any("cycle_persistent" in c for c in calls)


class _Recorder:
    """Stands in for the kernel library: records tpuamg_cycle_persistent's
    arguments and returns rc."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def tpuamg_cycle_persistent(self, args, nargs, flag, grid, smem,
                                stream):
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


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_cycle_launch_arguments(recorder, storage):
    """One launch with the program's tables, the caller's b, vc's coarse
    buffers and the program's splits, in _CYCLE_ARGS order (the order
    test_table_layouts_match_cuda_source holds against the CUDA source);
    z is vc's fine x buffer."""
    vc = _fused("w", storage).vc
    prog = vc.program()
    bm = _rhs(vc, 4)
    z = grid_fused._cycle_persistent(vc, bm)
    assert z.data_ptr() == vc._x[0].data_ptr()
    assert dict(kernels.LAUNCHES) == {"cycle_persistent": 1}
    (args, nargs, flag, grid, smem, stream), = recorder.calls
    got = dict(zip(grid_fused._CYCLE_ARGS, args))
    spec = vc.spec
    assert nargs == len(grid_fused._CYCLE_ARGS) == len(args)
    assert got == dict(
        levels=prog.levels_dev.data_ptr(), nlevels=len(spec.levels),
        ops=prog.ops_dev.data_ptr(), nops=len(prog), b=bm.data_ptr(),
        T=vc.T.data_ptr(), bc=vc._bc.data_ptr(), xc=vc._xc.data_ptr(),
        partial=prog.partial.data_ptr(), rows_c=spec.rows_c, nc=spec.nc,
        nsplit=prog.nsplit)
    assert flag == kernels.storage_flag(vc.A_planes[0])
    assert (grid, smem, stream) == (132, prog.shared_bytes(), 7)
    assert grid_fused.cycle_grid(vc) == (132, 1, 132)
    # other records of the same program: their own table and its size
    ops = prog.ops_dev[:2].clone()
    grid_fused._cycle_persistent(vc, bm, _ops=ops)
    args, _, _, _, smem, _ = recorder.calls[-1]
    got = dict(zip(grid_fused._CYCLE_ARGS, args))
    assert (got["ops"], got["nops"]) == (ops.data_ptr(), 2)
    assert smem == prog.level_table.nbytes + ops.numel() * 4


def test_cycle_launch_refusals(recorder):
    """A refused launch raises with the grid and the occupancy (nothing
    falls back to the sequenced cycle); a b that the cycle would
    overwrite is refused before any launch."""
    vc = _fused().vc
    recorder.rc = 720          # cudaErrorCooperativeLaunchTooLarge
    with pytest.raises(RuntimeError, match="resident blocks per SM"):
        grid_fused._cycle_persistent(vc, _rhs(vc), _grid=133)
    assert recorder.calls[-1][3] == 133
    assert not kernels.LAUNCHES["cycle_persistent"]
    n = len(recorder.calls)
    for buf in (vc._x[0], vc.program().x_alt[0], vc._d[0]):
        with pytest.raises(ValueError, match="overlaps"):
            grid_fused._cycle_persistent(vc, buf)
    assert len(recorder.calls) == n


def test_program_refuses_mixed_storage():
    """The kernels read A, C, M and T as one type."""
    vc = _fused(storage=torch.bfloat16).vc
    T = vc.T
    vc.T = T.float()
    with pytest.raises(TypeError, match="one storage type"):
        cp.CycleProgram(vc)
    vc.T = T
    cp.CycleProgram(vc)
