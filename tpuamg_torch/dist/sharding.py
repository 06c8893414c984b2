"""Sharding layer: row-partitioned grid hierarchies over torch.distributed.

Counterpart of the JAX package's ``dist/sharding.py`` for the grid
(DIA) hierarchy.  There, shardings annotate arrays and XLA inserts the
collectives; here every rank runs the same program on its own slab of
rows and calls the collectives itself:

* ``DeviceMesh`` carries this rank, the world size and the rank's
  device, with the two collectives the solve needs:
  ``all_reduce`` (sums of dots) and ``all_gather`` (whole vectors).
* A row-sharded level (``ShardedGridLevel``) holds the rows of a slab of
  its axis-0 grid rows (dof order is fields fastest, then the grid axes
  with axis 0 slowest, so a slab is contiguous).  Its operator is a
  ``dist_kernels.ShardedDIA`` (halo exchange + local sweep), its smoother
  the level's own class on the local node blocks.
* Levels smaller than ``replicate_below`` rows are replicated: every
  rank holds them whole and computes them redundantly, the coarse solve
  too.  Restriction from a sharded level into a replicated one gathers
  the residual first; prolongation back takes the rank's rows of the
  whole correction.  Between two sharded levels the 2x window transfers
  stay inside each slab.

Every host decision reads all-reduced (or replicated) values, which the
collectives return bit for bit the same on every rank, so the ranks stay
in lockstep.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..amg.grid import (ChebyshevDiagSmoother, GridLevel, window_spread,
                        window_sum)
from ..amg.hierarchy import MGPreconditioner
from ..amg.structured import BlockChebyshevSmoother
from .dist_kernels import ShardedDIA


class DeviceMesh:
    """The ranks of the default process group as a 1-D mesh ("p" in the
    JAX package): this rank, the world size and this rank's device."""

    def __init__(self, device):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.device = torch.device(device)

    def rows(self, n):
        """(start, stop) of this rank's slab of n rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        nl = n // self.size
        return self.rank * nl, (self.rank + 1) * nl

    def all_reduce(self, t):
        """Sum of t over the ranks, in place; returns t."""
        dist.all_reduce(t)
        return t

    def all_gather(self, x):
        """The ranks' slabs x, concatenated in rank order."""
        x = x.contiguous()
        out = torch.empty(self.size * x.shape[0], dtype=x.dtype,
                          device=x.device)
        dist.all_gather(list(out.chunk(self.size)), x)
        return out


def _local_rank():
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def _rank_device(device):
    """None or "cuda" -> cuda:{local rank} (an error without a card);
    anything else as given."""
    dev = kernels.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank())
    return dev


def device_mesh(device=None):
    """The mesh of every rank of the default group.  With no group
    initialized, first makes a one-rank group (NCCL for a CUDA device,
    gloo for the CPU) through a file store in a temporary directory.

    device: None = this rank's card (cuda:{LOCAL_RANK}); "cpu" with gloo."""
    if not dist.is_initialized():
        dev = kernels.resolve_device(device)
        tmp = tempfile.mkdtemp(prefix="tpuamg-store-")
        atexit.register(shutil.rmtree, tmp, True)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=1, rank=0)
    return DeviceMesh(_rank_device(device))


def init_multihost(device=None):
    """Start the default group from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK): NCCL for CUDA devices,
    gloo for the CPU; returns device_mesh().  Does nothing to a group
    that is already up."""
    if not dist.is_initialized():
        dev = kernels.resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return device_mesh(device)


def shard_vector(v, mesh):
    """This rank's slab of a whole vector."""
    a, z = mesh.rows(v.shape[0])
    return v[a:z].contiguous().to(mesh.device)


def replicate(x, mesh):
    """A whole tensor on every rank: each already holds it."""
    return x.to(mesh.device)


def shard_dia(A, mesh, row_sharded=True):
    """A DIA operator split by rows (a ShardedDIA), or as it is when
    replicated."""
    return ShardedDIA.from_dia(A, mesh) if row_sharded else A


class ShardedGridLevel(GridLevel):
    """A GridLevel whose rows are split over the mesh in axis-0 slabs.

    dims, mask, A (a ShardedDIA) and the smoother are the rank's own:
    dims[0] is the slab's axis-0 rows, ``gdims`` the level's.  Where the
    next level is sharded too, the window transfers run on the slab
    alone: then the slab's axis-0 rows are even (dims[0] = W k and
    ceil(W k / 2) divisible by W force k even for W > 1), so every
    window lies inside one slab, and the coarse slab is the next level's
    own.  Where the next level is replicated, restriction gathers the
    residual and restricts the whole of it, and prolongation spreads the
    whole correction and keeps this rank's rows."""

    def __init__(self, A, smoother, mask, gdims, F, mesh, next_sharded):
        gdims = tuple(gdims)
        ldims = (gdims[0] // mesh.size,) + gdims[1:]
        super().__init__(A, smoother, mask, ldims, F)
        self.gdims = gdims
        self.mesh = mesh
        self.next_sharded = bool(next_sharded)
        if not self.next_sharded:
            self.cdims = tuple((d + 1) // 2 for d in gdims)
            self.nc = int(np.prod(self.cdims)) * F

    def with_smoother(self, smoother):
        return ShardedGridLevel(self.A, smoother, self.mask, self.gdims,
                                self.F, self.mesh, self.next_sharded)

    def restrict(self, r):
        if self.next_sharded:
            return super().restrict(r)
        return window_sum(self.mesh.all_gather(r * self.mask), self.gdims,
                          self.F)

    def prolong(self, ec):
        if self.next_sharded:
            return super().prolong(ec)
        g = window_spread(ec, self.gdims, self.F)
        g = g.narrow(0, self.mesh.rank * self.dims[0], self.dims[0])
        return g.reshape(-1) * self.mask


def _is_sharded(L, mesh, replicate_below):
    return (L.A.shape[0] >= replicate_below
            and L.dims[0] % mesh.size == 0)


def _shard_smoother(sm, a, z, F):
    """The level smoother on rows [a, z)."""
    if isinstance(sm, BlockChebyshevSmoother):
        return BlockChebyshevSmoother(
            sm.blockinv[a // F:z // F].contiguous(),
            sm.mask[a:z].contiguous(), sm.lmax, sm.lmin, sm.degree, sm.kind)
    if isinstance(sm, ChebyshevDiagSmoother):
        return ChebyshevDiagSmoother(
            sm.invd[a:z].contiguous(), sm.mask[a:z].contiguous(), sm.lmax,
            sm.lmin, sm.degree, sm.kind)
    raise NotImplementedError(
        f"sharding a {type(sm).__name__}: shard_preconditioner takes the "
        f"plain grid hierarchy, setup_grid(pallas=False), whose levels "
        f"carry the Chebyshev smoothers of amg/structured.py and "
        f"amg/grid.py")


def _shard_grid_level(L, mesh, row_sharded, next_sharded=False):
    """A GridLevel split by rows over the mesh (or as it is, when
    replicated)."""
    if not row_sharded:
        return L
    a, z = mesh.rows(L.A.shape[0])
    return ShardedGridLevel(
        shard_dia(L.A, mesh), _shard_smoother(L.smoother, a, z, L.F),
        L.mask[a:z].contiguous(), L.dims, L.F, mesh, next_sharded)


def shard_preconditioner(prec: MGPreconditioner, mesh,
                         replicate_below=4096) -> MGPreconditioner:
    """Row-shard the levels of at least ``replicate_below`` rows whose
    axis-0 grid rows split evenly over the mesh; replicate the others and
    the coarse inverse.  Grid (GridLevel) hierarchies only."""
    for L in prec.levels:
        if type(L) is not GridLevel:
            raise NotImplementedError(
                f"sharding a {type(L).__name__}: the algebraic (ELL) and "
                f"structured hierarchies are ROADMAP Queue 1 items 12 and "
                f"10")
    sharded = [_is_sharded(L, mesh, replicate_below) for L in prec.levels]
    levels = [_shard_grid_level(L, mesh, s, nxt)
              for L, s, nxt in zip(prec.levels, sharded,
                                   sharded[1:] + [False])]
    return MGPreconditioner(levels, replicate(prec.coarse_inv, mesh),
                            cycle=prec.cycle, maxit=prec.maxit,
                            presmooth=prec.presmooth,
                            postsmooth=prec.postsmooth,
                            amli_degree=prec.amli_degree,
                            max_w_work=prec.max_w_work,
                            coarse_scaling=prec.coarse_scaling)
