"""Row-sharded DIA operators and the sharded Chebyshev smoother.

Counterpart of the JAX package's ``dist/pallas_dist.py``.  A level's rows
are split over the ranks of a ``sharding.DeviceMesh`` in contiguous
slabs; each rank holds its slab's DIA planes, (nd, n_local), and its
slab of every vector.  An operator application first fills a halo'd copy
of x, ``[halo | x | halo]`` with h = max|offset| entries on each side,
from the neighbouring ranks (``_exchange``), then sweeps the local planes
over it.  The distribution is exact: every application sees fresh halos,
so iteration counts do not depend on the number of ranks.

* ``ShardedDIA`` sweeps with the plain torch ops (``dia_spmv_plain``);
  ``sharding.shard_dia`` builds it.  ``ShardedPDIA`` takes PDIA's place
  on the sharded path: its sweep is K1's padded-x entry (``csrc/dia.cu``).
* ``cheb_step`` is one Chebyshev step on a shard, kernel K6
  (``csrc/cheb_step.cu``), with its plain version ``cheb_step_plain``.
* ``ShardedChebSmoother`` is the degree-k smoother: per step an exchange
  and a K6 launch, and for ``smooth_residual`` one more exchange and a
  K1 padded-x residual.  It runs on the level's own row partition, with
  two halo'd buffers that the steps write in turn; the JAX class's
  padding of the level to whole 128-lane row blocks, a layout rule of the
  TPU compiler, is gone.

As everywhere in the port, a wrapper runs its kernel on a CUDA tensor and
its plain version on a CPU tensor; the exchange itself is
``torch.distributed`` point-to-point traffic (NCCL on the card, gloo on
the CPU).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..sparse.dia_kernels import (_cheb_coefs, blockinv_dia, dia_spmv,
                                  dia_spmv_plain)


def _exchange(xh, h, mesh):
    """Fill the halos of xh = [top | x | bottom] (n_local + 2h entries)
    with the neighbouring ranks' edge rows, in place; returns xh.

    The ranks at the ends of the matrix receive nothing on their outer
    side: those halos stay as allocated, zero, which is what the DIA
    planes assume outside the matrix.  A one-rank world sends nothing.
    A halo wider than a shard (the deepest sharded levels) reaches
    past the neighbours: then every rank gathers the whole vector."""
    n = xh.shape[0] - 2 * h
    if h == 0 or mesh.size == 1:
        return xh
    if h > n:
        full = mesh.all_gather(xh[h:h + n])
        lo = mesh.rank * n - h
        a, z = max(lo, 0), min(lo + n + 2 * h, full.shape[0])
        xh[:a - lo].zero_()
        xh[z - lo:].zero_()
        xh[a - lo:z - lo].copy_(full[a:z])
        return xh
    ops = []
    r = mesh.rank
    if r > 0:
        ops += [dist.P2POp(dist.isend, xh[h:2 * h], r - 1),
                dist.P2POp(dist.irecv, xh[:h], r - 1)]
    if r < mesh.size - 1:
        ops += [dist.P2POp(dist.isend, xh[n:n + h], r + 1),
                dist.P2POp(dist.irecv, xh[n + h:], r + 1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return xh


def halo_shards(x, h, ndev):
    """The ndev row shards of a whole vector x, each with h entries of
    halo on each side, zeros beyond the ends of x: what ``_exchange``
    leaves in each rank's buffer."""
    n = x.shape[0]
    nl = n // ndev
    xp = torch.zeros(n + 2 * h, dtype=x.dtype, device=x.device)
    xp[h:h + n] = x
    return [xp[r * nl:r * nl + nl + 2 * h].contiguous() for r in range(ndev)]


class ShardedDIA:
    """Row-sharded DIA operator, plain torch ops.

    planes: (nd, n_local), this rank's rows of the global planes
    (planes[d, i] = A[row0 + i, row0 + i + offsets[d]]).  ``matvec`` and
    ``residual`` take and return this rank's slab of a vector; ``dots``
    gives inner products over all ranks.  Duck-type compatible with
    sparse.dia.DIA on the solve path."""

    def __init__(self, offsets, planes, shape, nnz, mesh):
        self.offsets = tuple(int(o) for o in offsets)
        self.planes = planes
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self.mesh = mesh
        self.h = max((abs(o) for o in self.offsets), default=0)
        self._xh = None          # the halo'd copy of x, made at first use

    @staticmethod
    def _sweep(offsets, planes, xh, b, h):
        return dia_spmv_plain(offsets, planes, xh, b, x_pad=h)

    @classmethod
    def from_dia(cls, A, mesh):
        """This rank's rows of a whole DIA (or KernelDIA) operator."""
        n = A.shape[0]
        if n % mesh.size:
            raise ValueError(f"n={n} not divisible by {mesh.size} ranks")
        nl = n // mesh.size
        planes = getattr(A, "planes", None)
        planes = A.data if planes is None else planes
        local = planes[:, mesh.rank * nl:(mesh.rank + 1) * nl].contiguous()
        return cls(A.offsets, local, A.shape, A.nnz, mesh)

    @property
    def data(self):
        return self.planes

    @property
    def dtype(self):
        return self.planes.dtype

    def _halo(self, x):
        n, h = x.shape[0], self.h
        if (self._xh is None or self._xh.dtype != x.dtype
                or self._xh.device != x.device):
            self._xh = torch.zeros(n + 2 * h, dtype=x.dtype,
                                   device=x.device)
        self._xh[h:h + n].copy_(x)
        return _exchange(self._xh, h, self.mesh)

    def matvec(self, x):
        return self._sweep(self.offsets, self.planes, self._halo(x), None,
                           self.h)

    def residual(self, x, b):
        """b - A @ x on this rank's rows."""
        return self._sweep(self.offsets, self.planes, self._halo(x), b,
                           self.h)

    def __matmul__(self, x):
        return self.matvec(x)

    def dots(self, *pairs):
        """[sum(u * v) for (u, v) in pairs] over every rank's slab, as one
        tensor: one all-reduce for all of them."""
        return self.mesh.all_reduce(
            torch.stack([torch.sum(u * v) for u, v in pairs]))

    def diagonal(self):
        if 0 in self.offsets:
            return self.planes[self.offsets.index(0)]
        return torch.zeros(self.planes.shape[1], dtype=self.dtype,
                           device=self.planes.device)


class ShardedPDIA(ShardedDIA):
    """ShardedDIA whose sweep is K1's padded-x entry on a CUDA tensor:
    per application one exchange and one launch on the local planes
    (float32 or bfloat16, float32 vectors), for any halo width."""

    @staticmethod
    def _sweep(offsets, planes, xh, b, h):
        return dia_spmv(offsets, planes, xh, b, x_pad=h)


# ---------------------------------------------------------------------------
# K6: one Chebyshev step on a shard, and its plain version
# ---------------------------------------------------------------------------

def cheb_step_plain(offsA, planesA, offsC, planesC, xh, h, b, d, first, s,
                    c, x_out=None, d_out=None):
    """One step in torch ops: returns (x_out, d_out).

    xh: the shard's x with h halo entries on each side; b, d: its rows.
    t = b - A x_h; d_out = s C t (first step, s = 1/theta) or
    s d + c C t (s = a_k, c = c_k); x_out = x + d_out.  Sums in x's dtype,
    planes cast to it.  x_out / d_out, where given, receive the result
    (d_out may be d)."""
    n = b.shape[0]
    t = dia_spmv_plain(offsA, planesA, xh, b, x_pad=h)
    ct = dia_spmv_plain(offsC, planesC, t)
    dn = s * ct if first else s * d + c * ct
    xn = xh[h:h + n] + dn
    if d_out is not None:
        dn = d_out.copy_(dn)
    if x_out is not None:
        xn = x_out.copy_(xn)
    return xn, dn


def cheb_step(offsA, planesA, offsC, planesC, xh, h, b, d, first, s, c, F,
              x_out=None, d_out=None):
    """One Chebyshev step on a shard (see cheb_step_plain): (x_out, d_out).

    CPU tensors: the plain version.  CUDA tensors: kernel K6, one launch;
    xh, b, d and the outputs float32, the planes float32 or bfloat16, the
    C offsets within one node block of F rows.  d_out may be d; x_out must
    not overlap xh."""
    if xh.device.type == "cpu":
        return cheb_step_plain(offsA, planesA, offsC, planesC, xh, h, b, d,
                               first, s, c, x_out, d_out)
    n = b.shape[0]
    dev = xh.device
    kernels.require(xh, "x_h", dtype=torch.float32, numel=n + 2 * h)
    for name, v in (("b", b), ("d", d)):
        kernels.require(v, name, dtype=torch.float32, numel=n, device=dev)
    kernels.require(planesA, "A planes", numel=len(offsA) * n, device=dev)
    kernels.require(planesC, "C planes", numel=len(offsC) * n, device=dev)
    if x_out is None:
        x_out = torch.empty(n, dtype=torch.float32, device=dev)
    if d_out is None:
        d_out = torch.empty(n, dtype=torch.float32, device=dev)
    for name, v in (("x_out", x_out), ("d_out", d_out)):
        kernels.require(v, name, dtype=torch.float32, numel=n, device=dev)
    if kernels.overlaps(x_out, xh):
        raise ValueError("x_out must not overlap x_h")
    rc = kernels.lib().tpuamg_cheb_step(
        planesA.data_ptr(), kernels.storage_flag(planesA), len(offsA),
        kernels.int_array(tuple(offsA)), planesC.data_ptr(),
        kernels.storage_flag(planesC), len(offsC),
        kernels.int_array(tuple(offsC)), xh.data_ptr(), int(h),
        b.data_ptr(), d.data_ptr(), x_out.data_ptr(), d_out.data_ptr(), n,
        int(F), int(bool(first)), float(s), float(c), kernels.stream_ptr())
    kernels.check(rc, "cheb_step")
    kernels.LAUNCHES["cheb_step"] += 1
    return x_out, d_out


class ShardedChebSmoother:
    """Distributed Chebyshev smoother: per step one halo exchange and one
    ``cheb_step`` (K6 on the card).

    Same recurrence as BlockChebyshevSmoother and FusedChebSmoother (the
    mask folded into the C planes), on the level's own shard of rows; C's
    node blocks never cross a shard edge (checked at build), so C needs no
    halo.  Two halo'd buffers per smoother: each step reads x from one and
    writes x_out into the other's interior.  Symmetric: reverse is a
    no-op.  The x that smooth returns is a view of a buffer, valid until
    this smoother's next application."""

    def __init__(self, offsA, planesA, offsC, planesC, F, lmax, lmin,
                 degree, mesh, kind=1):
        self.offsA = tuple(int(o) for o in offsA)
        self.planesA = planesA
        self.offsC = tuple(int(o) for o in offsC)
        self.planesC = planesC
        self.n = int(planesA.shape[1])
        self.h = max((abs(o) for o in self.offsA), default=0)
        self.F = int(F)
        self.lmax = lmax
        self.lmin = lmin
        self.degree = int(degree)
        self.kind = int(kind)
        self.mesh = mesh
        theta, coefs = _cheb_coefs(lmax, lmin, self.degree, self.kind)
        # (first, s, c) of every step
        self.steps = ((True, 1.0 / theta, 0.0),) + tuple(
            (False, a, c) for a, c in coefs)
        self._work = None        # (x buffer, x buffer, d), at first use

    @classmethod
    def build(cls, A, blockinv, mask, lmax, lmin, degree, mesh, kind=1):
        """A: the level's ShardedDIA; blockinv (ng_local, F, F) and mask
        (n_local,): this rank's node-block inverses and mask, on the host.
        Any halo width serves (``_exchange`` gathers one wider than a
        shard); raises ValueError where a node block would straddle a
        shard edge."""
        bi = np.asarray(blockinv, dtype=np.float64)
        F = bi.shape[1]
        nl = A.planes.shape[1]
        if nl % F or bi.shape[0] * F != nl:
            raise ValueError(f"F={F} blocks straddle the shard boundary "
                             f"(n_local={nl})")
        coffs, cdata = blockinv_dia(bi, np.asarray(mask, dtype=np.float64))
        planesC = torch.as_tensor(cdata).to(A.planes.dtype).to(
            A.planes.device)
        return cls(A.offsets, A.planes, coffs, planesC, F, lmax, lmin,
                   degree, mesh, kind)

    def _buffers(self, x):
        w = self._work
        if w is None or w[2].dtype != x.dtype or w[2].device != x.device:
            m = self.n + 2 * self.h
            w = self._work = (
                torch.zeros(m, dtype=x.dtype, device=x.device),
                torch.zeros(m, dtype=x.dtype, device=x.device),
                torch.zeros(self.n, dtype=x.dtype, device=x.device))
        return w

    def _sweep(self, x, b, iters, want_r):
        n, h = self.n, self.h
        cur, nxt, d = self._buffers(x)
        cur[h:h + n].copy_(x)
        for _ in range(int(iters)):
            for first, s, c in self.steps:
                _exchange(cur, h, self.mesh)
                cheb_step(self.offsA, self.planesA, self.offsC,
                          self.planesC, cur, h, b, d, first, s, c, self.F,
                          x_out=nxt[h:h + n], d_out=d)
                cur, nxt = nxt, cur
        r = None
        if want_r:
            _exchange(cur, h, self.mesh)
            r = dia_spmv(self.offsA, self.planesA, cur, b, x_pad=h)
        return cur[h:h + n], r

    def smooth(self, A, x, b, iters=1, reverse=False):
        del A, reverse    # symmetric; the operator's planes are carried
        return self._sweep(x, b, iters, False)[0]

    def smooth_residual(self, A, x, b, iters=1):
        """(x_smoothed, b - A x_smoothed): the smoothing steps, then one
        more exchange and a K1 padded-x residual."""
        del A
        return self._sweep(x, b, iters, True)
