"""DIA SpMV on the card: kernel K1 (csrc/dia.cu) and its plain version.

Counterpart of the JAX package's ``sparse/dia_pallas.py``.  ``KernelDIA``
takes PDIA's place: its ``matvec`` computes ``y = A x`` and its
``residual`` computes ``b - A x`` over static diagonal offsets, with the
planes held as one (nd, n) tensor, diagonal-major, in float32 or
bfloat16, and the sum taken in float32.  On a CUDA tensor the wrappers
launch K1; on a CPU tensor they run the plain version below (a sum of
shifted slices); on anything else they raise.  Up to ``kernels.
MAX_DIAGS`` (64) bands K1's entry takes the offsets by value; above that
(the structured 3D-1D path's operators, hundreds to thousands of bands)
its wide entry (``sparse/dia_tiles.py``, csrc/dia_tiles.cu) walks a
tile-compacted layout of the operator's nonzeros, which ``KernelDIA``
builds once: a rule on the band count, not a fallback.  The earlier wide
design, one thread per row over every padded plane (csrc/dia.cu), stays
as ``dia_spmv_wide_planes``, for comparison on the card only.

``FusedChebSmoother`` takes the place of the JAX package's smoother of
the same name: a whole Chebyshev sweep (``iters`` x degree steps of
t = b - A x, d = C t / theta or a d + c C t, x += d, and optionally the
final residual) is, on a CUDA tensor, ONE cooperative launch of kernel
K3 (csrc/cheb_persistent.cu), which runs the smoother's sweep program
(``amg.cycle_program.SweepProgram``) through the interpreter of the
persistent cycle kernels; on a CPU tensor it is the plain version
``cheb_sweep_plain``.  The earlier design of K3 (csrc/cheb.cu, two
launches per step) stays as ``cheb_sweep_sequenced``, for comparison on
the card only.

``dia_spmv_pallas`` is the counterpart of the JAX package's
``sparse/pallas_kernels.py`` (kernel ``_dia_kernel``, which nothing
there calls): y = A x as the JAX kernel computes it over a zero-padded
x, here K1 on the unpadded x, whose bounds checks give the zero halo.

Also here, copied: the host helpers ``_cheb_coefs`` and ``blockinv_dia``
that the fused hierarchy uses.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..amg.cycle_program import SweepProgram
from .dia_tiles import build_tiles, dia_spmv_tiles
from .host import HostCSR


# ---------------------------------------------------------------------------
# K1 and its plain version
# ---------------------------------------------------------------------------

def dia_spmv_plain(offsets, planes, x, b=None, out=None, x_pad=0):
    """sum_d planes[d] * x[i + offsets[d]] (zero outside [0, n)), or
    b minus that; accumulated in x's dtype (float32 for the kernel's
    inputs), the planes cast from their storage dtype.

    x_pad > 0: x holds n + 2 x_pad entries and row i reads
    x[i + x_pad + offsets[d]] (zero outside that buffer): a row shard
    with its halos, or a zero-padded whole vector."""
    n = x.shape[0] - 2 * x_pad
    acc = torch.zeros(n, dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off - x_pad), min(n, n + x_pad - off)
        if lo >= hi:
            continue
        p = planes[d].to(x.dtype)
        acc[lo:hi] += p[lo:hi] * x[lo + x_pad + off:hi + x_pad + off]
    y = acc if b is None else b - acc
    if out is None:
        return y
    return out.copy_(y)


def offsets_tensor(offsets, device):
    """The offsets as the int32 device array that the planes design of
    the wide entry (dia_spmv_wide_planes) reads."""
    return torch.as_tensor(np.asarray(offsets, dtype=np.int32)).to(device)


def dia_spmv(offsets, planes, x, b=None, out=None, x_pad=None):
    """y = A x (b is None) or y = b - A x, A in DIA planes (nd, n).

    x_pad: None reads x over [0, n); an int reads it from a buffer of
    n + 2 x_pad entries whose row i sits at i + x_pad (see
    dia_spmv_plain).

    CPU tensors: the plain version.  CUDA tensors: kernel K1, with x, b
    and out float32 and the planes float32 or bfloat16.  Which entry is a
    rule on the band count: up to ``kernels.MAX_DIAGS`` bands the offsets
    go by value (its padded-x entry when x_pad is an int); above it the
    wide entry walks a tile layout of the planes (``dia_tiles``), which
    this call builds for itself (counted as ``dia_tiles_build``):
    callers that repeat a call keep one, as KernelDIA does.  The wide
    entry has no padded-x form."""
    if x.device.type == "cpu":
        return dia_spmv_plain(offsets, planes, x, b, out, x_pad or 0)
    nd = len(offsets)
    if nd > kernels.MAX_DIAGS:
        if x_pad is not None:
            raise ValueError(f"K1's padded-x entry takes at most "
                             f"{kernels.MAX_DIAGS} diagonals, not {nd}")
        kernels.require(planes, "planes", numel=nd * x.shape[0],
                        device=x.device)
        return dia_spmv_tiles(build_tiles(offsets, planes), x, b, out)
    n = x.shape[0] - 2 * (x_pad or 0)
    kernels.require(x, "x", dtype=torch.float32)
    kernels.require(planes, "planes", numel=nd * n, device=x.device)
    if b is not None:
        kernels.require(b, "b", dtype=torch.float32, numel=n,
                        device=x.device)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=x.device)
    kernels.require(out, "out", dtype=torch.float32, numel=n,
                    device=x.device)
    if kernels.overlaps(out, x):
        raise ValueError("out must not overlap x")
    name = "dia_spmv" if b is None else "dia_residual"
    head = (planes.data_ptr(), kernels.storage_flag(planes), x.data_ptr())
    tail = (None if b is None else b.data_ptr(), out.data_ptr(), n, nd,
            kernels.int_array(tuple(offsets)), kernels.stream_ptr())
    if x_pad is None:
        rc = kernels.lib().tpuamg_dia_sweep(*head, *tail)
    else:
        name += "_pad"
        rc = kernels.lib().tpuamg_dia_sweep_pad(*head, int(x_pad), *tail)
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def dia_spmv_wide_planes(offsets, planes, x, b=None, out=None,
                         offsets_dev=None):
    """The earlier design of K1's wide entry, kept to time beside the tile
    walk on the card: csrc/dia.cu's dia_wide_kernel (tpuamg_dia_sweep_wide),
    one thread per row over every padded plane, the offsets from an int32
    device array (``offsets_tensor``; uploaded here when not given).
    CUDA tensors only; no route calls it.  Launch counts
    ``dia_spmv_wide_planes`` / ``dia_residual_wide_planes``."""
    n = x.shape[0]
    nd = len(offsets)
    kernels.require(x, "x", dtype=torch.float32)
    kernels.require(planes, "planes", numel=nd * n, device=x.device)
    if offsets_dev is None:
        offsets_dev = offsets_tensor(offsets, x.device)
    kernels.require(offsets_dev, "offsets", dtype=torch.int32, numel=nd,
                    device=x.device)
    if b is not None:
        kernels.require(b, "b", dtype=torch.float32, numel=n,
                        device=x.device)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=x.device)
    kernels.require(out, "out", dtype=torch.float32, numel=n,
                    device=x.device)
    if kernels.overlaps(out, x):
        raise ValueError("out must not overlap x")
    name = "dia_spmv_wide_planes" if b is None else "dia_residual_wide_planes"
    rc = kernels.lib().tpuamg_dia_sweep_wide(
        planes.data_ptr(), kernels.storage_flag(planes), x.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), n, nd,
        offsets_dev.data_ptr(), kernels.stream_ptr())
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def dia_spmv_pallas(A, x, block=8192):
    """y = A @ x for a DIA operator (DIA or KernelDIA) over any offsets:
    the counterpart of tpuamg/sparse/pallas_kernels.py:dia_spmv_pallas.

    The JAX kernel pads x with max|offset| zeros on both sides, so that
    row i reads xpad[i + pad + off] for every diagonal, and makes one
    pass over the padded x.  Row i's reads then land at indices
    i + off of x, and all those outside [0, n) are padding, i.e. zero.
    K1's unpadded entry reads exactly that: its bounds checks give 0
    outside [0, n).  So this calls K1 on x as it is, with no padded copy
    and nothing allocated but the output (the plain version on a CPU
    tensor).  Above kernels.MAX_DIAGS bands it is K1's wide entry, on the
    layout a KernelDIA keeps or, for a DIA, one built for the call.  The
    JAX kernel accepts only offsets that are multiples of 1024, a limit
    of the TPU compiler; this one takes any.  ``block`` sized the TPU
    kernel's VMEM tiles and is accepted and ignored."""
    del block
    if isinstance(A, KernelDIA):
        return A.matvec(x)
    planes = getattr(A, "planes", None)
    return dia_spmv(A.offsets, A.data if planes is None else planes, x)


class KernelDIA:
    """DIA operator whose matvec/residual run K1 on the card.

    planes: (nd, n) tensor, planes[d, i] = A[i, i + offsets[d]] (zero where
    out of range).  Duck-type compatible with sparse.dia.DIA on the solve
    path (matvec / residual / diagonal / shape / nnz / dtype)."""

    def __init__(self, offsets, planes, shape, nnz):
        self.offsets = tuple(int(o) for o in offsets)
        self.planes = planes
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self._tiles = None      # K1's wide layout, built at the first call

    @property
    def dtype(self):
        return self.planes.dtype

    @property
    def device(self):
        return self.planes.device

    @classmethod
    def from_dia(cls, D) -> "KernelDIA":
        return cls(D.offsets, D.data.contiguous(), D.shape, D.nnz)

    @classmethod
    def from_host(cls, A: HostCSR, dtype=torch.float32,
                  device=None) -> "KernelDIA":
        from .dia import DIA
        return cls.from_dia(DIA.from_host(A, dtype=dtype, device=device))

    def to_dia(self):
        from .dia import DIA
        return DIA(self.offsets, self.planes, self.shape, self.nnz)

    def to_host(self) -> HostCSR:
        return self.to_dia().to_host()

    def tiles(self):
        """The tile-compacted layout of the planes that K1's wide entry
        walks (dia_tiles.py), for more than kernels.MAX_DIAGS bands (None
        otherwise): built at the first call, on the planes' device, and
        built again only when ``planes`` was replaced or written in place
        since."""
        if len(self.offsets) <= kernels.MAX_DIAGS:
            return None
        if self._tiles is None or not self._tiles.fresh(self.planes):
            self._tiles = build_tiles(self.offsets, self.planes)
        return self._tiles

    def matvec(self, x):
        tiles = self.tiles()
        if tiles is None:
            return dia_spmv(self.offsets, self.planes, x)
        return dia_spmv_tiles(tiles, x)

    def residual(self, x, b):
        """b - A @ x in one K1 launch."""
        tiles = self.tiles()
        if tiles is None:
            return dia_spmv(self.offsets, self.planes, x, b)
        return dia_spmv_tiles(tiles, x, b)

    def diagonal(self):
        if 0 in self.offsets:
            return self.planes[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)


# ---------------------------------------------------------------------------
# Host helpers (copies)
# ---------------------------------------------------------------------------

def blockinv_dia(blockinv, mask=None):
    """Block-diagonal inverse (ng, F, F) as a (2F-1)-offset host-side DIA
    data array — so the smoother's B^{-1} apply is itself one DIA sweep.

    out[g*F + fi] = sum_fj blockinv[g, fi, fj] * r[g*F + fj]
    => offset o = fj - fi with plane c_o[i] = blockinv[i//F, i%F, i%F + o].
    mask (n,) rows are zeroed (ghost slots).  Returns (offsets, data)."""
    bi = np.asarray(blockinv)
    ng, F, _ = bi.shape
    n = ng * F
    offsets = list(range(-(F - 1), F))
    data = np.zeros((len(offsets), n))
    fi = np.arange(n) % F
    g = np.arange(n) // F
    for d, o in enumerate(offsets):
        fj = fi + o
        ok = (fj >= 0) & (fj < F)
        data[d, ok] = bi[g[ok], fi[ok], fj[ok]]
    if mask is not None:
        data *= np.asarray(mask)[None, :]
    return offsets, data


def _cheb_coefs(lmax, lmin, degree, kind=1):
    """Coefficients of the degree-`degree` polynomial smoother recurrence

        d_1 = r_0 / theta;   d_k = a_k d_{k-1} + c_k r_{k-1};  x += d_k

    kind=1: classical first-kind Chebyshev on [lmin, lmax].
    kind=4: fourth-kind Chebyshev (Lottes, 'Optimal polynomial smoothers
    for multigrid', arXiv:2202.08830): needs only the upper spectral bound
    (lmin ignored) and damps the whole [0, lmax] band."""
    if kind == 4:
        theta = 0.75 * lmax                       # d_1 = 4/(3 lmax) r_0
        coefs = []
        for k in range(1, degree):
            ak = (2.0 * k - 1.0) / (2.0 * k + 3.0)
            ck = (8.0 * k + 4.0) / ((2.0 * k + 3.0) * lmax)
            coefs.append((float(ak), float(ck)))
        return float(theta), tuple(coefs)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    coefs = []
    for _k in range(1, degree):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coefs.append((float(rho_new * rho), float(2.0 * rho_new / delta)))
        rho = rho_new
    return float(theta), tuple(coefs)


# ---------------------------------------------------------------------------
# K3: the whole Chebyshev sweep, and its plain version
# ---------------------------------------------------------------------------

def cheb_sweep_plain(offsA, planesA, offsC, planesC, x, b, theta, coefs,
                     degree, iters=1, want_r=False):
    """The sweep in torch ops: returns (x_new, b - A x_new or None).

    Per step: t = b - A x; d = C t / theta (first step) or
    a_k d + c_k C t; x += d.  Sums in x's dtype, planes cast to it."""
    x = x.clone()
    d = torch.zeros_like(x)
    s = 1.0 / theta
    for _ in range(iters):
        for k in range(degree):
            t = dia_spmv_plain(offsA, planesA, x, b)
            ct = dia_spmv_plain(offsC, planesC, t)
            if k == 0:
                d = s * ct
            else:
                a, c = coefs[k - 1]
                d = a * d + c * ct
            x += d
    r = dia_spmv_plain(offsA, planesA, x, b) if want_r else None
    return x, r


class _ChebConsts:
    """What a launch of the sequenced K3 (csrc/cheb.cu) takes that does
    not change between applications: the plane pointers and flags, the
    offsets and coefficients as ctypes arrays, 1/theta, and the (t, d)
    scratch."""

    def __init__(self, offsA, planesA, offsC, planesC, n, theta, coefs,
                 degree):
        if len(coefs) != degree - 1:
            raise ValueError(f"{len(coefs)} coefficient pairs for degree "
                             f"{degree}")
        kernels.require(planesA, "A planes", numel=len(offsA) * n)
        kernels.require(planesC, "C planes", numel=len(offsC) * n,
                        device=planesA.device)
        self.device = planesA.device
        self.n = int(n)
        self.work = tuple(torch.empty(n, dtype=torch.float32,
                                      device=planesA.device)
                          for _ in range(2))
        self.head = (planesA.data_ptr(), kernels.storage_flag(planesA),
                     len(offsA), kernels.int_array(tuple(offsA)),
                     planesC.data_ptr(), kernels.storage_flag(planesC),
                     len(offsC), kernels.int_array(tuple(offsC)))
        self.degree = int(degree)
        self.inv_theta = float(1.0 / theta)
        flat = [float(v) for ac in coefs for v in ac]
        self.coefs = (ctypes.c_float * max(len(flat), 1))(*flat)

    def launch(self, x, b, iters, want_r):
        """The sequenced K3 on x and b: (x_new, r or None), x unchanged."""
        kernels.require(x, "x", dtype=torch.float32, numel=self.n,
                        device=self.device)
        kernels.require(b, "b", dtype=torch.float32, numel=self.n,
                        device=self.device)
        t, d = self.work
        out = x.clone()
        r = torch.empty_like(x) if want_r else None
        rc = kernels.lib().tpuamg_cheb_sweep(
            *self.head, out.data_ptr(), b.data_ptr(), t.data_ptr(),
            d.data_ptr(), None if r is None else r.data_ptr(), self.n,
            self.degree, int(iters), self.inv_theta, self.coefs,
            kernels.stream_ptr())
        kernels.check(rc, "cheb_sweep_sequenced")
        kernels.LAUNCHES["cheb_sweep_sequenced"] += 1
        return out, r


# the host argument vector of tpuamg_cheb_persistent, in its order
_CHEB_ARGS = ("levels", "nlevels", "ops", "nops", "x", "b", "x_out", "r")


def _cheb_persistent(prog: SweepProgram, x, b, iters, want_r, _grid=None):
    """One application as one cooperative launch of K3
    (csrc/cheb_persistent.cu) running prog's sweep program: (x_new, r or
    None), both allocated here (torch.empty, no launch), x unchanged.
    Nothing runs when the program is empty (no step and no r): x_new is
    then a copy of x, as the plain version gives.  _grid overrides the
    grid (a card test asks for one too large to be co-resident)."""
    from ..amg import grid_fused
    kernels.require(x, "x", dtype=torch.float32, numel=prog.n,
                    device=prog.device)
    kernels.require(b, "b", dtype=torch.float32, numel=prog.n,
                    device=prog.device)
    out = torch.empty_like(x) if iters * prog.degree else x.clone()
    r = torch.empty_like(x) if want_r else None
    table = prog.op_table(iters, want_r)
    if not len(table):
        return out, r
    smem = prog.shared_bytes(iters, want_r)
    grid, per_sm, sms = grid_fused._grid_of("cheb", prog.planesA, smem)
    grid = grid if _grid is None else int(_grid)
    vals = dict(levels=prog.levels_dev.data_ptr(),
                nlevels=prog.level_table.shape[0], ops=table.data_ptr(),
                nops=len(table), x=x.data_ptr(), b=b.data_ptr(),
                x_out=out.data_ptr(), r=0 if r is None else r.data_ptr())
    args = (ctypes.c_longlong * len(_CHEB_ARGS))(
        *(vals[k] for k in _CHEB_ARGS))
    rc = kernels.lib().tpuamg_cheb_persistent(
        args, len(_CHEB_ARGS), kernels.storage_flag(prog.planesA), grid,
        smem, kernels.stream_ptr())
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel cheb_persistent failed: cudaError {rc} on a grid "
            f"of {grid} blocks x 512 threads ({sms} SMs x {per_sm} "
            f"resident blocks per SM)")
    kernels.LAUNCHES["cheb_sweep"] += 1
    return out, r


def _node_size(offsC):
    """The node block size the C offsets -(F-1)..F-1 imply."""
    return max((abs(int(o)) for o in offsC), default=0) + 1


def cheb_sweep(offsA, planesA, offsC, planesC, x, b, theta, coefs, degree,
               iters=1, want_r=False):
    """One smoother application: (x_new, r or None), x left unchanged.

    CPU tensors: the plain version.  CUDA tensors: kernel K3, one
    cooperative launch of the sweep program (a program built for this
    call; FusedChebSmoother builds its own once).  x and b float32, the
    planes float32 or bfloat16, both of one type; C the nodal block
    inverse over node blocks of the size its offsets imply."""
    if x.device.type == "cpu":
        return cheb_sweep_plain(offsA, planesA, offsC, planesC, x, b, theta,
                                coefs, degree, iters, want_r)
    prog = SweepProgram(offsA, planesA, offsC, planesC, x.shape[0],
                        _node_size(offsC), theta, coefs, degree)
    return _cheb_persistent(prog, x, b, iters, want_r)


def cheb_sweep_sequenced(offsA, planesA, offsC, planesC, x, b, theta, coefs,
                         degree, iters=1, want_r=False):
    """The earlier design of K3, kept to time it beside the one-launch
    kernel on the card: csrc/cheb.cu, 2 launches per step (the t-pass,
    then the C-apply) and one for r, from one C call, after a copy of x.
    CUDA tensors only; no route calls it.  Same contract as cheb_sweep
    (any C, and A and C planes of either type)."""
    return _ChebConsts(offsA, planesA, offsC, planesC, x.shape[0], theta,
                       coefs, degree).launch(x, b, iters, want_r)


class FusedChebSmoother:
    """Chebyshev smoother whose whole sweep is one kernel launch.

    Holds its own A and C (= masked B^{-1}) planes, (nd, n) in float32 or
    bfloat16, on the unfused hierarchy's interleaved layout (no padding),
    C over node blocks of F rows, the size its offsets -(F-1)..F-1
    imply.
    Drop-in for BlockChebyshevSmoother on the grid path: the ``A``
    argument of smooth() is ignored, and reverse is a no-op (Chebyshev is
    self-adjoint in the B inner product).  On CPU tensors it runs
    ``cheb_sweep_plain``; on CUDA tensors kernel K3 on its sweep program
    (``program()``, built at the first launch)."""

    def __init__(self, offsA, planesA, offsC, planesC, n, lmax, lmin,
                 degree=3, kind=1):
        self.offsA = tuple(int(o) for o in offsA)
        self.planesA = planesA
        self.offsC = tuple(int(o) for o in offsC)
        self.planesC = planesC
        self.n = int(n)
        self.F = _node_size(self.offsC)
        self.lmax = lmax
        self.lmin = lmin
        self.degree = int(degree)
        self.kind = int(kind)
        self.theta, self.coefs = _cheb_coefs(lmax, lmin, self.degree,
                                             self.kind)
        self._program = None

    @classmethod
    def build(cls, A_dia, C_dia, lmax, lmin, degree=3, kind=1):
        """From two DIA (or KernelDIA) operators over the same n."""
        pa = getattr(A_dia, "planes", None)
        pc = getattr(C_dia, "planes", None)
        return cls(A_dia.offsets, A_dia.data if pa is None else pa,
                   C_dia.offsets, C_dia.data if pc is None else pc,
                   A_dia.shape[0], lmax, lmin, degree, kind)

    def program(self) -> SweepProgram:
        """K3's sweep program: the level table and the smoother's own d,
        second x and t, built once."""
        if self._program is None:
            self._program = SweepProgram(
                self.offsA, self.planesA, self.offsC, self.planesC, self.n,
                self.F, self.theta, self.coefs, self.degree)
        return self._program

    def _sweep(self, x, b, iters, want_r):
        if x.device.type == "cpu":
            return cheb_sweep_plain(self.offsA, self.planesA, self.offsC,
                                    self.planesC, x, b, self.theta,
                                    self.coefs, self.degree, int(iters),
                                    want_r)
        return _cheb_persistent(self.program(), x, b, int(iters), want_r)

    def smooth(self, A, x, b, iters=1, reverse=False):
        del A, reverse
        return self._sweep(x, b, iters, False)[0]

    def smooth_residual(self, A, x, b, iters=1):
        """(x_smoothed, b - A x_smoothed) in one sweep."""
        del A
        return self._sweep(x, b, iters, True)
