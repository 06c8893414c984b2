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
