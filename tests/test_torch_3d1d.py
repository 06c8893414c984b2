"""The 3D-1D pipeline of tpuamg_torch against the JAX package's, on the
CPU, at the JAX tests' sizes (tests/test_problems.py, tests/test_io.py):
the coupling operator, the assembled system and its dofs, the .dat
parse, dumps and solution files across the two packages, the neuron
HDF5 loader, run_solver_3d1d at gamma 1 and 1e8, and -load_solution's
VTU files."""
import dataclasses
import os
import shutil

import numpy as np
import pytest

from tpuamg.fem import unit_cube_mesh as j_cube
from tpuamg.problems import emi_3d1d as J
from tpuamg_torch.fem import unit_cube_mesh
from tpuamg_torch.fem.coupling import average_matrix
from tpuamg_torch.problems import emi_3d1d as T
from tpuamg_torch.problems import run_solver_3d1d as TR

JAX_DAT = "tpuamg/problems/input_metric.dat"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The pipeline's solves are many small torch ops; with the suite's
    workers sharing the cores, one intra-op thread each keeps them from
    spinning against each other."""
    import torch
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):     # the Schwarz inverses
        yield
    torch.set_num_threads(n)


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= rtol * scale


def _dense(M):
    return M.toarray()


@pytest.mark.parametrize("radius", [0.0, 0.2])
def test_average_matrix_matches_jax(radius):
    """Pi entry by entry: at radius 0.2 the circle's points land on faces
    and edges of the tets, where TetLocator's eps decides the tet."""
    from tpuamg.fem.coupling import average_matrix as j_average
    mesh, jmesh = unit_cube_mesh(8), j_cube(8)
    curve = T.synthetic_neuron_curve(n_main=20, n_branches=2)
    jcurve = J.synthetic_neuron_curve(n_main=20, n_branches=2)
    np.testing.assert_array_equal(curve.vertices, jcurve.vertices)
    np.testing.assert_array_equal(curve.cells, jcurve.cells)
    Pi = average_matrix(mesh, curve, radius=radius)
    ref = j_average(jmesh, jcurve, radius=radius)
    assert Pi.shape == ref.shape == (curve.num_vertices, mesh.num_vertices)
    _close(_dense(Pi), _dense(ref))
    # every row averages: weights sum to one
    _close(_dense(Pi).sum(axis=1), np.ones(curve.num_vertices))


@pytest.mark.parametrize("gamma", [1.0, 1e8])
def test_get_system_matches_jax(gamma):
    mesh, curve = unit_cube_mesh(6), T.synthetic_neuron_curve()
    A, b, sizes, (Pi, Mq) = T.get_system(
        mesh, curve, k3=3.0, k1=7.0 * np.pi * 0.04, gamma=gamma,
        coupling_radius=0.2, return_coupling=True)
    jA, jb, jsizes, (jPi, jMq) = J.get_system(
        j_cube(6), J.synthetic_neuron_curve(), k3=3.0,
        k1=7.0 * np.pi * 0.04, gamma=gamma, coupling_radius=0.2,
        return_coupling=True)
    assert sizes == jsizes
    for got, ref in ((A, jA), (Pi, jPi), (Mq, jMq)):
        _close(_dense(got), _dense(ref))
    _close(b, jb)


def test_dofs_match_jax():
    from tpuamg.fem import tagged_unit_cube as j_tagged, dofs as jdofs
    from tpuamg.fem.mesh import (mesh_from_facets as j_facets,
                                 submesh_where_marker as j_sub)
    from tpuamg_torch.fem import (tagged_unit_cube, mesh_from_facets,
                                  submesh_where_marker, dofs)
    out = []
    for tagged, facets, sub, mod in (
            (tagged_unit_cube, mesh_from_facets, submesh_where_marker,
             dofs),
            (j_tagged, j_facets, j_sub, jdofs)):
        m = tagged(4)
        m.mark_cells(lambda x: x[:, 0] < 0.5, 1)
        inner = sub(m, 1)
        iface = facets(m.facets_with_tag(1), m)
        out.append((mod.get_interface_dofs(m, iface),
                    mod.get_coupling_dofs(m, inner)))
    (gi, gc), (ri, rc) = out
    assert len(gi) > 0 and len(gc) > 0
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gc, rc)


def test_dat_copy_parses_as_the_jax_file():
    from tpuamg.io_utils import (parse_dat_file as j_parse,
                                 dat_to_amg_parameters as j_params)
    from tpuamg_torch.io_utils import parse_dat_file, dat_to_amg_parameters
    assert os.path.samefile(TR.DEFAULT_INFILE,
                            "tpuamg_torch/problems/input_metric.dat")
    assert parse_dat_file(TR.DEFAULT_INFILE) == j_parse(JAX_DAT)
    amg, sol = dat_to_amg_parameters(TR.DEFAULT_INFILE)
    jamg, jsol = j_params(JAX_DAT)
    assert dataclasses.asdict(amg) == dataclasses.asdict(jamg)
    assert dataclasses.asdict(sol) == dataclasses.asdict(jsol)
    assert (sol.method, sol.stop_type, sol.tolerance) == ("cg", 1, 1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dump_loads_in_the_other_package(tmp_path, writer):
    import tpuamg.io_utils as jio
    import tpuamg_torch.io_utils as tio
    mesh, curve = unit_cube_mesh(5), T.synthetic_neuron_curve(n_main=8,
                                                                n_branches=1)
    gamma = 1e4
    A, b, sizes, (Pi, Mq) = T.get_system(mesh, curve, gamma=gamma,
                                         coupling_radius=0.2,
                                         return_coupling=True)
    coords = np.concatenate([mesh.vertices, curve.vertices])
    w, r = (tio, jio) if writer == "port" else (jio, tio)
    if writer == "jax":
        from tpuamg.sparse import HostCSR as JCSR
        A, Pi, Mq = (JCSR(M.indptr, M.indices, M.data, M.shape)
                     for M in (A, Pi, Mq))
    d = str(tmp_path / "d")
    w.dump_system(A, b, sizes, d, coords=coords, coupling=(Pi, Mq),
                  gamma=gamma)
    A2, b2, idofs, idofs3d, c2 = r.load_system(d, with_coords=True)
    g2, Pi2, Mq2 = r.load_coupling(d)
    np.testing.assert_array_equal(A2.toarray(), A.toarray())
    np.testing.assert_array_equal(b2, b)
    np.testing.assert_array_equal(c2, coords)
    np.testing.assert_array_equal(idofs, np.arange(sizes[0], sum(sizes)))
    np.testing.assert_array_equal(idofs3d, np.arange(sizes[0]))
    assert g2 == gamma
    np.testing.assert_array_equal(Pi2.toarray(), Pi.toarray())
    np.testing.assert_array_equal(Mq2.toarray(), Mq.toarray())
    assert r.load_coupling(str(tmp_path)) is None


def test_solution_file_round_trip(tmp_path):
    from tpuamg.io_utils import read_solution as j_read
    from tpuamg_torch.io_utils import read_solution, write_solution
    x = np.random.default_rng(0).standard_normal(37)
    path = write_solution(str(tmp_path), x)
    assert path == os.path.join(str(tmp_path), "solution.txt")
    assert np.loadtxt(path)[0] == 37
    np.testing.assert_array_equal(read_solution(str(tmp_path)), x)
    np.testing.assert_array_equal(j_read(path), x)


def _write_neuron_h5(path, curve, extra_zero_edge=True):
    """tests/test_problems.py's DOLFIN-layout fixture."""
    import h5py
    rng = np.random.default_rng(3)
    coords = curve.vertices.copy()
    topo = curve.cells.astype(np.int64)
    vals = rng.uniform(0.1, 1.0, len(topo))
    if extra_zero_edge:
        coords = np.vstack([coords, [[9.0, 9.0, 9.0]]])
        topo = np.vstack([topo, [[0, len(coords) - 1]]])
        vals = np.concatenate([vals, [0.0]])
    with h5py.File(path, "w") as h5:
        h5["/mesh/coordinates"] = coords
        h5["/mesh/topology"] = topo
        h5.create_group("curves")["values"] = vals


def test_load_neuron_h5_matches_jax(tmp_path, monkeypatch):
    curve = T.synthetic_neuron_curve(n_main=10, n_branches=2)
    p = str(tmp_path / "neuron.h5")
    _write_neuron_h5(p, curve)
    m, ref = T.load_neuron_h5(p), J.load_neuron_h5(p)
    np.testing.assert_array_equal(m.vertices, ref.vertices)
    np.testing.assert_array_equal(m.cells, ref.cells)
    assert m.num_vertices == curve.num_vertices
    # without h5py: an ImportError that says so
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        T.load_neuron_h5(p)


def _jax_crossing_solve(d):
    """The JAX package's solve of a dump as its run_solver_3d1d makes it
    off the TPU (the .dat parameters, clustered Schwarz, metric_hazmath,
    float64), with chunk=1: its x is then the crossing iterate."""
    import jax.numpy as jnp
    from tpuamg.io_utils import dat_to_amg_parameters, load_system
    from tpuamg.problems.solve import solve_system
    amg, cfg = dat_to_amg_parameters(JAX_DAT)
    A, b, idofs, idofs3d = load_system(d)
    return solve_system(A, b, "metric_hazmath",
                        (len(idofs3d), len(b) - len(idofs3d)), idofs=idofs,
                        params=dataclasses.replace(amg, schwarz_cluster=True),
                        tol=cfg.tolerance, maxiter=cfg.maxiter,
                        method=cfg.method, stop_type=cfg.stop_type,
                        dtype=jnp.float64, chunk=1)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """The port's dump at gamma 1 and 1e8 (mesh_n 6, radius 0.2), solved
    by both packages' run_solver_3d1d with the .dat defaults, and by the
    JAX solve_system as that driver calls it, with chunk=1."""
    from tpuamg.problems.run_solver_3d1d import main as j_solver
    root = tmp_path_factory.mktemp("emi3d1d")
    out = {}
    for gamma in ("1", "100000000"):
        d, o, oj = (str(root / f"{k}{gamma}") + "/"
                    for k in ("dump", "out", "outj"))
        assert T.main(["-gamma", gamma, "-radius", "0.2", "-dump", "1",
                       "-outdir", d, "-mesh_n", "6"]) == 0
        ref = j_solver(["-infile", JAX_DAT, "-indir", d, "-outdir", oj])
        one = _jax_crossing_solve(d)
        got = TR.main(["-indir", d, "-outdir", o], device="cpu")
        out[gamma] = (d, o, oj, ref, one, got)
    return out


@pytest.mark.parametrize("gamma", ["1", "100000000"])
def test_run_solver_3d1d_matches_jax(pipelines, gamma):
    """tests/test_problems.py::test_emi_3d1d_gamma_robust, the JAX
    driver's iterations, and x against the JAX solve's crossing iterate
    (chunk=1)."""
    d, o, oj, ref, one, got = pipelines[gamma]
    assert ref.converged and one.converged and got.converged
    assert got.niters == ref.niters == one.niters <= 25, \
        (gamma, got.niters, ref.niters, one.niters)
    _close(got.x, one.x, 1e-8)
    assert got.executed <= got.niters + 1
    from tpuamg_torch.io_utils import load_system, read_solution
    np.testing.assert_array_equal(read_solution(o), got.x)
    A, b, _, _ = load_system(d)
    rel = np.linalg.norm(b - A.matvec(got.x)) / np.linalg.norm(b)
    assert rel <= 1e-6, rel


def test_load_solution_writes_the_jax_vtu_files(pipelines):
    """-load_solution on the port's solution writes the VTU files the JAX
    package writes from the same solution.txt."""
    d, o, oj, *_ = pipelines["1"]
    both = []
    for pkg, main in (("port", T.main), ("jax", J.main)):
        dd = d.rstrip("/") + f"_{pkg}/"
        os.makedirs(dd)
        shutil.copy(os.path.join(o, "solution.txt"), dd)
        assert main(["-gamma", "1", "-radius", "0.2", "-load_solution", dd,
                     "-mesh_n", "6", "-outdir", dd]) == 0
        both.append({f: open(os.path.join(dd, f)).read()
                     for f in sorted(os.listdir(dd)) if f.endswith(".vtu")})
    assert sorted(both[0]) == ["uh0_gamma1.0.vtu", "uh1_gamma1.0.vtu"]
    assert both[0] == both[1]


def test_in_process_solve(tmp_path):
    """emi_3d1d's default mode: assemble and solve in-process, then
    solution.txt in -outdir."""
    from tpuamg_torch.io_utils import read_solution
    o = str(tmp_path) + "/"
    assert T.main(["-gamma", "100", "-radius", "0.2", "-mesh_n", "4",
                   "-outdir", o], device="cpu") == 0
    x = read_solution(o)
    assert x.shape == (125 + 88,) and np.isfinite(x).all()


def test_keep_idofs_raises(tmp_path):
    """-keep_idofs acts on the structured route, whose idof stride blocks
    need the tiled slot order: on a dump whose bulk is off its lattice
    ("auto" falls back to Morton) it raises ValueError, as the JAX
    package's setup_structured does.  (It runs on a lattice dump:
    tests/test_torch_host_tail.py::test_run_solver_keep_idofs_runs.)"""
    d = str(tmp_path) + "/"
    assert T.main(["-dump", "1", "-mesh_n", "3", "-outdir", d]) == 0
    crd = np.load(d + "coords.npy")
    n3 = len(np.load(d + "idofs3d.npy"))
    crd[:n3] += 1e-3 * np.random.default_rng(0).standard_normal((n3, 3))
    np.save(d + "coords.npy", crd)
    with pytest.raises(ValueError, match="keep_idofs"):
        TR.main(["-indir", d, "-outdir", d, "-route", "structured",
                 "-keep_idofs", "1", "-algebraic_below", "50"],
                device="cpu")


def test_entry_points_need_a_device_without_cuda(tmp_path, monkeypatch):
    """Both entry points solve on the card unless device="cpu" is given."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path) + "/"
    assert T.main(["-dump", "1", "-mesh_n", "3", "-outdir", d]) == 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.main(["-indir", d, "-outdir", d])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.main(["-mesh_n", "3", "-outdir", d])
