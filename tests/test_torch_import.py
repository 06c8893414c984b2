"""tpuamg_torch stands alone: importing it loads neither JAX nor the JAX
package, builds nothing, and its entry points refuse to fall back to the
CPU quietly."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

_PROBE = """
import sys
import tpuamg_torch
import tpuamg_torch.kernels, tpuamg_torch.state
import tpuamg_torch.sparse.dia, tpuamg_torch.sparse.dia_kernels
import tpuamg_torch.sparse.dia_tiles
import tpuamg_torch.amg.grid_fused, tpuamg_torch.krylov.cg
import tpuamg_torch.amg.cycle_program
import tpuamg_torch.problems.bidomain, tpuamg_torch.fem.mms
import tpuamg_torch.problems.solve, tpuamg_torch.problems.bidomain_2d
import tpuamg_torch.problems.driver, tpuamg_torch.amg.grid
import tpuamg_torch.amg.hierarchy, tpuamg_torch.amg.structured
import tpuamg_torch.io_utils, tpuamg_torch.fem.error
import tpuamg_torch.dist, tpuamg_torch.dist.dist_kernels
import tpuamg_torch.dist.sharding, tpuamg_torch.dist.solve
import tpuamg_torch.native, tpuamg_torch.sparse.device
import tpuamg_torch.amg.strength, tpuamg_torch.amg.prolongation
import tpuamg_torch.amg.aggregation, tpuamg_torch.smoothers
import tpuamg_torch.smoothers.relaxation, tpuamg_torch.smoothers.schwarz
import tpuamg_torch.smoothers.schwarz_setup
import tpuamg_torch.krylov.minres, tpuamg_torch.krylov.gmres
import tpuamg_torch.config, tpuamg_torch.io_utils.datfile
import tpuamg_torch.io_utils.dump, tpuamg_torch.io_utils.vtk
import tpuamg_torch.fem.dofs, tpuamg_torch.fem.coupling
import tpuamg_torch.problems.emi_3d1d, tpuamg_torch.problems.run_solver_3d1d
import tpuamg_torch.native.tail
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'tpuamg'))
print('BAD', bad)
print('LIB', tpuamg_torch.kernels._lib)
print('NATIVE', tpuamg_torch.native._lib)
print('TAIL', tpuamg_torch.native.tail._lib)
"""


def test_import_loads_neither_jax_nor_tpuamg():
    # tests/conftest.py imports both into this process: probe a fresh one
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1]).stdout
    assert "BAD []" in out, out
    assert "LIB None" in out, out      # nothing built or loaded at import
    assert "NATIVE None" in out, out
    assert "TAIL None" in out, out


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    from tpuamg_torch import kernels
    from tpuamg_torch.sparse import HostCSR
    from tpuamg_torch.sparse.dia_kernels import KernelDIA
    from tpuamg_torch.amg.grid_fused import setup_grid_fused
    from tpuamg_torch.amg.grid import setup_grid
    from tpuamg_torch.problems.solve import solve_system
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = HostCSR.from_coo(np.arange(4), np.arange(4), np.ones(4), (4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernels.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelDIA.from_host(A)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_grid_fused(A, (2, 2), F=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_grid(A, (2, 2), F=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_system(A, np.ones(4), "metric_mono", (4,), grid=((2, 2), 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_system(A, np.ones(4), "metric_mono", (4,))
    from tpuamg_torch.amg.hierarchy import setup_amg
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_amg(A)
    from tpuamg_torch.dist import device_mesh, distributed_grid_solve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed_grid_solve(A, np.ones(4), (2, 2), F=1)
    from tpuamg_torch.amg.structured import (setup_structured,
                                             structured_system)
    crd = np.arange(8.0).reshape(4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_structured(A, crd)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        structured_system(A, np.arange(4), 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_system(A, np.ones(4), "metric_mono", (4,),
                     structured_coords=crd)
    assert KernelDIA.from_host(A, device="cpu").planes.device.type == "cpu"
