"""tpuamg_torch.dist on gloo CPU ranks against the JAX package's
distributed grid solve.

Each world (1, 2, 4 and 8 ranks) is spawned once for the module, all
side by side; its ranks run every case of that world and write what they
got to a file each.  The ranks import torch and tpuamg_torch only: JAX
and the JAX package are imported inside the fixtures that compute the
references.  The JAX solves run one PCG iteration per chunk (chunk=1),
so that, as the port's, they return the crossing iterate.

* n=16, dims (17, 17), F=2, gamma 1e6, f32, V-cycle, coarse_dof 60, tol
  1e-6, on 1, 2 and 8 ranks, against the JAX distributed_grid_solve
  (pallas=False) on as many virtual devices: equal nflat, levels and
  sharded_levels, iterations within 1, x within 1e-3 relative, true
  residual under 1e-5.
* f64, shard_depth 1, pallas=False on 8 ranks (tests/test_dist.py's
  test_distributed_grid_solve_pads_and_shards): equal iterations, x
  within 1e-8.
* n=64, gamma 1e6, f32, tol 1e-8, kernel classes (their plain versions
  on the CPU), on 1/2/4/8 ranks, against the JAX record
  docs/sample_results/dist_scaling.txt: 18 iterations, its nflat, and
  pallas_levels == sharded_levels == 4.
* On 2 and 8 ranks, ShardedChebSmoother and ShardedPDIA with real halo
  exchanges against BlockChebyshevSmoother and DIA on
  tests/test_dist_pallas.py's inputs, and on a matrix whose halo (40
  rows) is wider than a shard of 8 ranks (16 rows).
* n=4, dims (5, 5), coarse_dof 10, shard_depth 1, f32, with the kernel
  classes on 8 ranks, where the second level's halo (9 rows) is wider
  than its shard (6 rows):
  every sharded level takes ShardedChebSmoother and the outer operator
  ShardedPDIA; against the JAX solve (pallas=False, which pads this grid
  as its kernels would have) the same checks as the n=16 case.
* NL-AMLI(2) at n=16, coarse_dof 10, shard_depth 1, in f64 on 2 ranks
  (its steepest-descent steps read all-reduced dots) against the JAX solve on 2 virtual devices:
  equal iterations, the residual history within 1e-6, x within 1e-8.
* Every rank ends with the same x.

The 2-rank world starts its group the way torchrun's environment would
(``init_multihost``, a localhost address); the others through a file
store.
"""
import os
import pickle
import socket
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLDS = (1, 2, 4, 8)
F32_WORLDS = (1, 2, 8)
AMLI_WORLDS = (2,)
KERNEL_WORLDS = (2, 8)
# docs/sample_results/dist_scaling.txt: ndev -> nflat (18 iterations,
# pallas_lv = sharded_lv = 4, outer_pallas 1 on every row)
RECORD_NFLAT = {1: 15360, 2: 18432, 4: 24576, 8: 24576}
NSM = 128 * 8 * 8           # the smoother case's rows
NPD = 2 * NSM               # the SpMV case's rows
NWIDE, WIDE_H = 128, 40     # the wide-halo case: rows and halo


def _system(n, gamma):
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, gamma)
    A, b, _, _ = get_system(get_mesh(n, 2), mms.setup_bidomain_mms(p, 2), p)
    return A, b


def _banded(n, offsets, seed):
    """tests/test_dist_pallas.py's random banded DIA planes, as float32."""
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n))
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = rng.standard_normal(hi - lo) * 0.1
    data[offsets.index(0), :] += 4.0
    return data.astype(np.float32)


def _smoother_inputs():
    """tests/test_dist_pallas.py::test_sharded_cheb_matches_block_smoother"""
    F, offsets = 2, [-128, -2, -1, 0, 1, 2, 128]
    data = _banded(NSM, offsets, 2)
    rng = np.random.default_rng(3)
    blockinv = np.linalg.inv(rng.standard_normal((NSM // F, F, F)) * 0.1
                             + 2 * np.eye(F))
    mask = np.ones(NSM)
    mask[-7:] = 0.0
    x = rng.standard_normal(NSM).astype(np.float32)
    b = rng.standard_normal(NSM).astype(np.float32)
    return offsets, data, blockinv, mask, x, b


def _spmv_inputs():
    """tests/test_dist_pallas.py::test_sharded_pdia_matches_dia"""
    offsets = [-130, -128, -3, -1, 0, 1, 3, 128, 130]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(NPD).astype(np.float32)
    b = rng.standard_normal(NPD).astype(np.float32)
    return offsets, _banded(NPD, offsets, 0), x, b


def _wide_inputs():
    """A smoother case like _smoother_inputs whose halo is WIDE_H rows."""
    offsets = [-WIDE_H, -2, -1, 0, 1, 2, WIDE_H]
    data = _banded(NWIDE, offsets, 4)
    rng = np.random.default_rng(5)
    blockinv = np.linalg.inv(rng.standard_normal((NWIDE // 2, 2, 2)) * 0.1
                             + 2 * np.eye(2))
    mask = np.ones(NWIDE)
    mask[-3:] = 0.0
    x = rng.standard_normal(NWIDE).astype(np.float32)
    b = rng.standard_normal(NWIDE).astype(np.float32)
    return offsets, data, blockinv, mask, x, b


def _kernel_checks(mesh):
    """ShardedChebSmoother and ShardedPDIA on this rank's rows; returns
    the gathered results."""
    from tpuamg_torch.dist.dist_kernels import (ShardedChebSmoother,
                                                ShardedDIA, ShardedPDIA)
    from tpuamg_torch.sparse.dia import DIA
    out = {}
    for tag, (n, inputs) in (("", (NSM, _smoother_inputs())),
                             ("wide ", (NWIDE, _wide_inputs()))):
        offsets, data, blockinv, mask, x, b = inputs
        a, z = mesh.rows(n)
        A = ShardedDIA(offsets, torch.as_tensor(data[:, a:z]).contiguous(),
                       (n, n), 0, mesh)
        sm = ShardedChebSmoother.build(A, blockinv[a // 2:z // 2],
                                       mask[a:z], 2.5, 0.3, 3, mesh)
        xl, bl = torch.as_tensor(x[a:z]), torch.as_tensor(b[a:z])
        out[tag + "y2"] = mesh.all_gather(
            sm.smooth(None, xl, bl, iters=2)).numpy()
        y1, r1 = sm.smooth_residual(None, xl, bl, iters=1)
        out[tag + "y1"] = mesh.all_gather(y1).numpy()
        out[tag + "r1"] = mesh.all_gather(r1).numpy()
    wo, wd, _, _, wx, wb = _wide_inputs()
    for tag, (n, (offsets, data, x, b)) in (
            ("", (NPD, _spmv_inputs())), ("wide ", (NWIDE, (wo, wd, wx, wb)))):
        P = ShardedPDIA.from_dia(DIA(offsets, torch.as_tensor(data),
                                     (n, n)), mesh)
        a, z = mesh.rows(n)
        xl, bl = torch.as_tensor(x[a:z]), torch.as_tensor(b[a:z])
        out[tag + "Ax"] = mesh.all_gather(P.matvec(xl)).numpy()
        out[tag + "b-Ax"] = mesh.all_gather(P.residual(xl, bl)).numpy()
    return out


def _rank(rank, world, store, systems, keys, kernel_checks, out):
    """One rank of a world: the cases named by keys, read from the pickle
    file systems, then the kernel checks.  store: a file for a file store,
    or a localhost port, which the rank reaches as torchrun would tell it
    to (init_multihost)."""
    torch.set_num_threads(1)
    with open(systems, "rb") as f:
        cases = pickle.load(f)
    from tpuamg_torch.dist import (device_mesh, init_multihost,
                                   setup_distributed_grid)
    from tpuamg_torch.dist.dist_kernels import ShardedChebSmoother
    if isinstance(store, int):
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(store),
                          RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        mesh = init_multihost("cpu")
    else:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=300))
        mesh = device_mesh("cpu")
    try:
        assert (mesh.rank, mesh.size) == (rank, world)
        got = {}
        for key in keys:
            A, b, dims, kw = cases[key]
            kw = dict(kw)
            tol, maxiter = kw.pop("tol"), kw.pop("maxiter")
            # distributed_grid_solve is these two calls; the set-up is
            # kept to read each K6 level's halo and rows
            prob = setup_distributed_grid(A, b, dims, F=2, mesh=mesh, **kw)
            res = prob.solve(tol, maxiter)
            got[key] = dict(niters=res.niters, converged=res.converged,
                            x=res.x, info=res.dist_info,
                            residuals=res.residuals,
                            halo_rows=[(L.smoother.h, L.smoother.n)
                                       for L in prob.prec.levels
                                       if isinstance(L.smoother,
                                                     ShardedChebSmoother)])
        if kernel_checks:
            got["kernels"] = _kernel_checks(mesh)
        with open(out.format(rank), "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


F32_KW = dict(tol=1e-6, maxiter=60, pallas=False, dtype=torch.float32)
F32K_WORLDS = (8,)
F64_KW = dict(tol=1e-8, maxiter=60, pallas=False, dtype=torch.float64,
              shard_depth=1)
N64_KW = dict(tol=1e-8, maxiter=120)


@pytest.fixture(scope="module")
def systems():
    from tpuamg_torch.config import AMGParameters
    A16, b16 = _system(16, 1e6)
    A4k, b4k = _system(4, 1e6)
    A4, b4 = _system(16, 1e4)
    A64, b64 = _system(64, 1e6)
    f32 = AMGParameters(cycle_type="v", maxit=1, coarse_dof=60,
                        dtype="float32")
    f32k = AMGParameters(cycle_type="v", maxit=1, coarse_dof=10,
                         dtype="float32")
    # shard_depth 1 splits the real rows evenly enough between 2 ranks
    # that one rank's dots differ from the sum; coarse_dof 10 makes the
    # inner steps inexact, so their step lengths matter
    amli = AMGParameters(cycle_type="nl_amli", amli_degree=2, maxit=1,
                         coarse_dof=10, dtype="float64")
    return {"f32": (A16, b16, (17, 17), dict(F32_KW, params=f32)),
            "f32k": (A4k, b4k, (5, 5),
                     dict(F32_KW, params=f32k, pallas=True, shard_depth=1)),
            "amli": (A16, b16, (17, 17), dict(F64_KW, params=amli)),
            "f64": (A4, b4, (17, 17),
                    dict(F64_KW, params=AMGParameters(cycle_type="v",
                                                      dtype="float64"))),
            "n64": (A64, b64, (65, 65), N64_KW)}


@pytest.fixture(scope="module")
def worlds(systems, tmp_path_factory):
    """{world: [what each rank got]}; each world spawned once, all of them
    side by side (most of a rank's time is waiting on its peers)."""
    env = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                          "OPENBLAS_NUM_THREADS",
                                          "MKL_NUM_THREADS")}
    # one BLAS thread per rank: the ranks share this host's cores
    os.environ.update({k: "1" for k in env})
    # the systems go to the ranks through a file: a large argument would
    # make each start wait until its rank has imported torch
    cases = str(tmp_path_factory.mktemp("systems") / "systems.pkl")
    with open(cases, "wb") as f:
        pickle.dump(systems, f)
    outs, running = {}, []
    try:
        for w in WORLDS:
            tmp = tmp_path_factory.mktemp(f"world{w}")
            keys = (["n64"] + ["f32"] * (w in F32_WORLDS)
                    + ["f32k"] * (w in F32K_WORLDS)
                    + ["amli"] * (w in AMLI_WORLDS) + ["f64"] * (w == 8))
            outs[w] = str(tmp / "rank{}.pkl")
            store = _free_port() if w == 2 else str(tmp / "store")
            running.append(mp.start_processes(
                _rank, args=(w, store, cases, keys,
                             w in KERNEL_WORLDS, outs[w]),
                nprocs=w, join=False, start_method="spawn"))
        for ctx in running:
            while not ctx.join():
                pass
    finally:
        for ctx in running:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    got = {}
    for w, out in outs.items():
        got[w] = []
        for r in range(w):
            with open(out.format(r), "rb") as f:
                got[w].append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def jax_solves(systems):
    """The JAX distributed_grid_solve (pallas=False) on as many virtual
    devices as each world has ranks, its pcg given chunk=1: its x is then
    the crossing iterate, as the port's is."""
    from functools import partial
    import jax.numpy as jnp
    from tpuamg.config import AMGParameters as JParams
    from tpuamg.dist import device_mesh as jmesh
    from tpuamg.dist import solve as jdist
    from tpuamg.krylov import pcg as jpcg
    from tpuamg.sparse import HostCSR

    def jsolve(*a, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdist, "pcg", partial(jpcg, chunk=1))
            return jdist.distributed_grid_solve(*a, **kw)

    def jcsr(A):
        return HostCSR(A.indptr, A.indices, A.data, A.shape)
    out = {}
    A, b, dims, _ = systems["f32"]
    A = jcsr(A)
    prm = JParams(cycle_type="v", maxit=1, coarse_dof=60, dtype="float32")
    for w in F32_WORLDS:
        out["f32", w] = jsolve(A, b, dims, F=2, params=prm, mesh=jmesh(w),
                               tol=1e-6, maxiter=60, pallas=False,
                               dtype=jnp.float32)[0]
    A, b, dims, _ = systems["f32k"]
    prm = JParams(cycle_type="v", maxit=1, coarse_dof=10, dtype="float32")
    for w in F32K_WORLDS:
        out["f32k", w] = jsolve(jcsr(A), b, dims, F=2, params=prm,
                                mesh=jmesh(w), tol=1e-6, maxiter=60,
                                pallas=False, dtype=jnp.float32,
                                shard_depth=1)[0]
    A, b, dims, _ = systems["amli"]
    out["amli", 2] = jsolve(jcsr(A), b, dims, F=2, params=JParams(
        cycle_type="nl_amli", amli_degree=2, maxit=1, coarse_dof=10,
        dtype="float64"), mesh=jmesh(2), tol=1e-8, maxiter=60,
        dtype=jnp.float64, shard_depth=1, pallas=False)[0]
    A, b, dims, _ = systems["f64"]
    A = jcsr(A)
    out["f64", 8] = jsolve(A, b, dims, F=2,
                           params=JParams(cycle_type="v", dtype="float64"),
                           mesh=jmesh(8), tol=1e-8, maxiter=60,
                           dtype=jnp.float64, shard_depth=1,
                           pallas=False)[0]
    return out


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("world", F32_WORLDS)
def test_f32_solve_matches_jax(worlds, jax_solves, systems, world):
    A, b = systems["f32"][:2]
    got, ref = worlds[world][0]["f32"], jax_solves["f32", world]
    for key in ("nflat", "levels", "sharded_levels"):
        assert got["info"][key] == ref.dist_info[key], key
    assert got["info"]["ndev"] == world
    assert got["converged"] and abs(got["niters"] - ref.niters) <= 1
    assert _rel(got["x"], ref.x) <= 1e-3
    assert _rel(b, A.matvec(got["x"])) <= 1e-5


@pytest.mark.parametrize("world", F32K_WORLDS)
def test_f32_kernel_classes_take_wide_halos(worlds, jax_solves, systems,
                                            world):
    A, b = systems["f32k"][:2]
    got, ref = worlds[world][0]["f32k"], jax_solves["f32k", world]
    info = got["info"]
    for key in ("nflat", "levels", "sharded_levels"):
        assert info[key] == ref.dist_info[key], key
    assert info["pallas_levels"] == info["sharded_levels"] > 0
    assert info["outer_pallas"] and info["ndev"] == world
    assert len(got["halo_rows"]) == info["sharded_levels"]
    assert any(h > n for h, n in got["halo_rows"]), got["halo_rows"]
    assert got["converged"] and abs(got["niters"] - ref.niters) <= 1
    assert _rel(got["x"], ref.x) <= 1e-3
    assert _rel(b, A.matvec(got["x"])) <= 1e-5


def test_f64_shard_depth_1_matches_jax(worlds, jax_solves, systems):
    A, b = systems["f64"][:2]
    got, ref = worlds[8][0]["f64"], jax_solves["f64", 8]
    assert got["info"]["sharded_levels"] == ref.dist_info["sharded_levels"]
    assert got["info"]["nflat"] == ref.dist_info["nflat"]
    assert got["converged"] and got["niters"] == ref.niters
    np.testing.assert_allclose(got["residuals"], ref.residuals, rtol=1e-6)
    np.testing.assert_allclose(got["x"], ref.x, rtol=0, atol=1e-8)
    assert _rel(b, A.matvec(got["x"])) < 1e-6


@pytest.mark.parametrize("world", WORLDS)
def test_n64_matches_jax_record(worlds, world):
    got = worlds[world][0]["n64"]
    info = got["info"]
    assert got["converged"] and got["niters"] == 18
    assert info["nflat"] == RECORD_NFLAT[world]
    assert info["pallas_levels"] == info["sharded_levels"] == 4
    assert info["outer_pallas"] and info["ndev"] == world


def test_nl_amli_matches_jax(worlds, jax_solves, systems):
    A, b = systems["amli"][:2]
    got, ref = worlds[2][0]["amli"], jax_solves["amli", 2]
    assert got["info"]["sharded_levels"] == ref.dist_info["sharded_levels"]
    assert got["converged"] and got["niters"] == ref.niters
    np.testing.assert_allclose(got["residuals"], ref.residuals, rtol=1e-6)
    np.testing.assert_allclose(got["x"], ref.x, rtol=0, atol=1e-8)
    assert _rel(b, A.matvec(got["x"])) < 1e-6


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_x(worlds, world):
    ranks = worlds[world]
    for key in ranks[0]:
        if key == "kernels":
            continue
        for other in ranks[1:]:
            assert other[key]["niters"] == ranks[0][key]["niters"]
            assert np.array_equal(other[key]["x"], ranks[0][key]["x"])


@pytest.fixture(scope="module")
def jax_kernel_refs():
    import jax.numpy as jnp
    from tpuamg.amg.structured import BlockChebyshevSmoother
    from tpuamg.sparse.dia import DIA
    offsets, data, blockinv, mask, x, b = _smoother_inputs()
    A = DIA(offsets, jnp.asarray(data), (NSM, NSM))
    ref = BlockChebyshevSmoother(jnp.asarray(blockinv, dtype=jnp.float32),
                                 jnp.asarray(mask, dtype=jnp.float32), 2.5,
                                 0.3, 3)
    xj, bj = jnp.asarray(x), jnp.asarray(b)
    y1 = np.asarray(ref.smooth(A, xj, bj, iters=1))
    out = {"y2": np.asarray(ref.smooth(A, xj, bj, iters=2)), "y1": y1,
           "r1": b - np.asarray(A.matvec(jnp.asarray(y1)))}
    offsets, data, x, b = _spmv_inputs()
    A = DIA(offsets, jnp.asarray(data), (NPD, NPD))
    out["Ax"] = np.asarray(A.matvec(jnp.asarray(x)))
    out["b-Ax"] = np.asarray(A.residual(jnp.asarray(x), jnp.asarray(b)))
    offsets, data, blockinv, mask, x, b = _wide_inputs()
    A = DIA(offsets, jnp.asarray(data), (NWIDE, NWIDE))
    ref = BlockChebyshevSmoother(jnp.asarray(blockinv, dtype=jnp.float32),
                                 jnp.asarray(mask, dtype=jnp.float32), 2.5,
                                 0.3, 3)
    xj, bj = jnp.asarray(x), jnp.asarray(b)
    y1 = np.asarray(ref.smooth(A, xj, bj, iters=1))
    out["wide y2"] = np.asarray(ref.smooth(A, xj, bj, iters=2))
    out["wide y1"] = y1
    out["wide r1"] = b - np.asarray(A.matvec(jnp.asarray(y1)))
    out["wide Ax"] = np.asarray(A.matvec(xj))
    out["wide b-Ax"] = np.asarray(A.residual(xj, bj))
    return out


@pytest.mark.parametrize("world", KERNEL_WORLDS)
def test_sharded_smoother_and_pdia_match_jax(worlds, jax_kernel_refs,
                                             world):
    got = worlds[world][0]["kernels"]
    ref = jax_kernel_refs
    assert _rel(got["y2"], ref["y2"]) < 1e-5
    assert _rel(got["y1"], ref["y1"]) < 1e-5
    assert _rel(got["r1"], ref["r1"]) < 1e-4
    assert _rel(got["Ax"], ref["Ax"]) < 1e-6
    assert _rel(got["b-Ax"], ref["b-Ax"]) < 1e-6


@pytest.mark.parametrize("world", KERNEL_WORLDS)
def test_wide_halo_smoother_and_pdia_match_jax(worlds, jax_kernel_refs,
                                               world):
    """At 8 ranks the halo spans three neighbours' shards."""
    got = worlds[world][0]["kernels"]
    ref = jax_kernel_refs
    assert (WIDE_H > NWIDE // world) == (world == 8)
    assert _rel(got["wide y2"], ref["wide y2"]) < 1e-5
    assert _rel(got["wide y1"], ref["wide y1"]) < 1e-5
    assert _rel(got["wide r1"], ref["wide r1"]) < 1e-4
    assert _rel(got["wide Ax"], ref["wide Ax"]) < 1e-6
    assert _rel(got["wide b-Ax"], ref["wide b-Ax"]) < 1e-6
