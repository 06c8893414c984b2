"""K1's wide entry: a DIA operator of any band count, walked through a
tile-compacted layout of its nonzeros (csrc/dia_tiles.cu), and the plain
version of that walk.

A DIA operator over n rows is (nd, n) planes, planes[d, i] = A[i, i +
offsets[d]].  With hundreds of bands most plane entries are zeros: the
slot order's padding and bands that only other rows use.  ``build_tiles``
packs the operator once into a layout that holds only the nonzeros:

- rows in tiles of ``rows`` (T) rows;
- per tile, the bands with any nonzero in the tile, as their offsets
  (``tile_off``, int32, tile t's list at ``band_ptr[t]:band_ptr[t+1]``,
  in stored diagonal order);
- per row, its nonzero entries in stored diagonal order, each a local
  band index into its tile's list (``idx``) and the value in the planes'
  dtype (``vals``).  A tile's entries are sliced-ELL: every row of the
  tile gets W entries, W the tile's longest row rounded up to GROUP, and
  entry k of lane l (row t*T + l) sits at ``ent_ptr[t] + ((k // GROUP) *
  T + l) * GROUP + k % GROUP``: GROUP consecutive entries of one row are
  one vector load, and a warp's loads are contiguous.  Padding entries
  have value 0.

An entry is a nonzero when its plane value is not 0 and its column
i + offsets[d] lies in [0, n); the plain sum and the kernel both skip
what is left out, which adds nothing for finite x.  Local indices are
uint8 when every tile has at most 256 bands (indices 0..255), else uint16
(kept in an int16 tensor, bit for bit); a tile of more than 65,536 bands
cannot be built and raises ValueError.

``dia_tiles_plain`` is the plain walk: on the CPU it equals
``dia_spmv_plain`` bit for bit (the same products, added per row in the
same order, less the exact zeros).  ``dia_spmv_tiles`` launches the
kernel on CUDA tensors and runs the plain walk on CPU tensors.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from .. import kernels

TILE_ROWS = 32      # T: one warp per tile
GROUP = 4           # entries per vector load (csrc/dia_tiles.cu: kGroup)
THREADS = 256       # threads per block of the kernel
MAX_UINT8_BANDS = 256
MAX_UINT16_BANDS = 65536


@dataclass
class DiaTiles:
    """The tile-compacted layout of one DIA operator (module docstring).
    ``planes`` is the tensor it was built from (to tell a stale layout);
    ``version`` that tensor's ``_version`` at the build."""
    n: int
    rows: int
    vals: torch.Tensor          # (entries,) planes' dtype
    idx: torch.Tensor           # (entries,) uint8, or int16 holding uint16
    ent_ptr: torch.Tensor       # (tiles + 1,) int64
    band_ptr: torch.Tensor      # (tiles + 1,) int32
    tile_off: torch.Tensor      # (sum of bands per tile,) int32
    nnz: int                    # real entries (no padding)
    max_bands: int              # most bands of any tile
    planes: torch.Tensor = field(repr=False)
    version: int = 0
    _walk: tuple = field(default=None, repr=False)
    _head: object = field(default=None, repr=False)

    @property
    def idx_bytes(self) -> int:
        return self.idx.element_size()

    @property
    def device(self):
        return self.vals.device

    @property
    def tiles(self) -> int:
        return self.ent_ptr.numel() - 1

    def stream_bytes(self) -> int:
        """What one walk of the layout reads: values and indices with
        their padding, and the per-tile tables."""
        return (self.vals.numel() * self.vals.element_size()
                + self.idx.numel() * self.idx_bytes
                + self.ent_ptr.numel() * 8 + self.band_ptr.numel() * 4
                + self.tile_off.numel() * 4)

    def kernel_args(self):
        """The layout's argument array of tpuamg_dia_tiles (pointers,
        types, tile rows, n: a host ctypes array kept here), checked at
        the first launch: contiguous CUDA tensors of one device, values
        and indices aligned for GROUP-entry loads."""
        if self._head is None:
            dev = self.vals.device
            for t, what in ((self.vals, "values"), (self.idx, "indices")):
                kernels.require(t, what, device=dev)
                if t.data_ptr() % (GROUP * t.element_size()):
                    raise ValueError(f"{what}: not aligned for {GROUP}-entry "
                                     f"loads")
            for t, what in ((self.ent_ptr, "ent_ptr"),
                            (self.band_ptr, "band_ptr"),
                            (self.tile_off, "tile_off")):
                kernels.require(t, what, device=dev)
            vals = (self.vals.data_ptr(), kernels.storage_flag(self.vals),
                    self.idx.data_ptr(), self.idx_bytes,
                    self.ent_ptr.data_ptr(), self.band_ptr.data_ptr(),
                    self.tile_off.data_ptr(), self.rows, self.n)
            self._head = (ctypes.c_longlong * len(vals))(*vals)
        return self._head

    def fresh(self, planes: torch.Tensor) -> bool:
        """Whether the layout was built from these planes as they are."""
        return planes is self.planes and planes._version == self.version


def build_tiles(offsets, planes: torch.Tensor, rows: int = TILE_ROWS
                ) -> DiaTiles:
    """The layout of the DIA operator (offsets, planes (nd, n)), built with
    torch ops on the planes' device, values in the planes' dtype.  A build
    on the card adds one to ``kernels.LAUNCHES["dia_tiles_build"]``."""
    nd, n = planes.shape
    if len(offsets) != nd:
        raise ValueError(f"{len(offsets)} offsets for {nd} planes")
    if rows <= 0:
        raise ValueError(f"tile rows {rows}: must be positive")
    dev = planes.device
    if dev.type == "cuda":
        kernels.LAUNCHES["dia_tiles_build"] += 1
    ntiles = -(-n // rows)
    npad = ntiles * rows
    mask = torch.zeros((nd, npad), dtype=torch.bool, device=dev)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -int(off)), min(n, n - int(off))
        if lo < hi:
            mask[d, lo:hi] = planes[d, lo:hi] != 0
    has = mask.view(nd, ntiles, rows).any(2).T.contiguous()   # (tiles, nd)
    nbands = has.sum(1)
    max_bands = int(nbands.max()) if ntiles else 0
    if max_bands > MAX_UINT16_BANDS:
        raise ValueError(f"a tile of {rows} rows has {max_bands} bands: "
                         f"the layout holds at most {MAX_UINT16_BANDS}")
    offs = torch.as_tensor([int(o) for o in offsets], dtype=torch.int64,
                           device=dev)
    tb = torch.nonzero(has)                       # (t, d), t-major, d up
    tile_off = offs[tb[:, 1]].to(torch.int32)
    band_ptr = torch.zeros(ntiles + 1, dtype=torch.int64, device=dev)
    band_ptr[1:] = torch.cumsum(nbands, 0)
    loc = torch.cumsum(has.to(torch.int32), 1) - 1          # (tiles, nd)
    count = mask.sum(0)                                     # (npad,)
    width = (count.view(ntiles, rows).amax(1) + GROUP - 1) // GROUP * GROUP
    ent_ptr = torch.zeros(ntiles + 1, dtype=torch.int64, device=dev)
    ent_ptr[1:] = torch.cumsum(width * rows, 0)
    entries = int(ent_ptr[-1])
    ent = torch.nonzero(mask.T)                   # (i, d), i-major, d up
    i, d = ent[:, 0], ent[:, 1]
    start = torch.cumsum(count, 0) - count
    k = torch.arange(len(i), device=dev) - start[i]
    t, lane = i // rows, i % rows
    pos = ent_ptr[t] + ((k // GROUP) * rows + lane) * GROUP + k % GROUP
    vals = torch.zeros(entries, dtype=planes.dtype, device=dev)
    vals[pos] = planes[d, i]
    local = loc[t, d]
    if max_bands <= MAX_UINT8_BANDS:
        idx = torch.zeros(entries, dtype=torch.uint8, device=dev)
        idx[pos] = local.to(torch.uint8)
    else:   # uint16 bit patterns in an int16 tensor
        idx = torch.zeros(entries, dtype=torch.int16, device=dev)
        idx[pos] = torch.where(local >= 32768, local - 65536,
                               local).to(torch.int16)
    return DiaTiles(n=n, rows=rows, vals=vals, idx=idx, ent_ptr=ent_ptr,
                    band_ptr=band_ptr.to(torch.int32), tile_off=tile_off,
                    nnz=len(i), max_bands=max_bands, planes=planes,
                    version=planes._version)


def _walk_geometry(tiles: DiaTiles):
    """Per entry of the layout: its row and its rank k within the row;
    and the widest row's width.  Cached on the layout."""
    if tiles._walk is None:
        T, dev = tiles.rows, tiles.device
        per_tile = tiles.ent_ptr[1:] - tiles.ent_ptr[:-1]
        t = torch.repeat_interleave(
            torch.arange(tiles.tiles, device=dev), per_tile)
        e = torch.arange(tiles.vals.numel(), device=dev) - tiles.ent_ptr[t]
        g, rem = e // (GROUP * T), e % (GROUP * T)
        row = t * T + rem // GROUP
        k = g * GROUP + rem % GROUP
        width = int(per_tile.max()) // T if tiles.tiles else 0
        tiles._walk = (row, k, t, width)
    return tiles._walk


def _local_index(tiles: DiaTiles) -> torch.Tensor:
    idx = tiles.idx.to(torch.int64)
    return idx & 0xFFFF if tiles.idx.dtype == torch.int16 else idx


def dia_tiles_plain(tiles: DiaTiles, x, b=None, out=None):
    """y = A x (b is None) or b - A x from the layout, in torch ops: gather
    x at each entry's row plus its tile's band offset, multiply by the
    value (cast to x's dtype), and add the products of each row in its
    stored diagonal order; sums in x's dtype."""
    n = tiles.n
    row, k, t, width = _walk_geometry(tiles)
    live = tiles.vals != 0
    row_l, k_l, t_l = row[live], k[live], t[live]
    off = tiles.tile_off[tiles.band_ptr[t_l].to(torch.int64)
                         + _local_index(tiles)[live]].to(torch.int64)
    prod = tiles.vals[live].to(x.dtype) * x[row_l + off]
    P = torch.zeros((n, width), dtype=x.dtype, device=x.device)
    P[row_l, k_l] = prod
    acc = torch.zeros(n, dtype=x.dtype, device=x.device)
    for c in range(width):
        acc += P[:, c]
    y = acc if b is None else b - acc
    if out is None:
        return y
    return out.copy_(y)


def dia_spmv_tiles(tiles: DiaTiles, x, b=None, out=None):
    """y = A x (b is None) or y = b - A x through the layout.

    CPU tensors: the plain walk.  CUDA tensors: one launch of
    csrc/dia_tiles.cu (launch counts ``dia_spmv_wide`` /
    ``dia_residual_wide``), x, b and out float32 on the layout's device,
    the values float32 or bfloat16."""
    if x.device.type == "cpu":
        return dia_tiles_plain(tiles, x, b, out)
    n = tiles.n
    head = tiles.kernel_args()
    kernels.require(x, "x", dtype=torch.float32, numel=n, device=tiles.device)
    if b is not None:
        kernels.require(b, "b", dtype=torch.float32, numel=n,
                        device=x.device)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=x.device)
    else:
        kernels.require(out, "out", dtype=torch.float32, numel=n,
                        device=x.device)
        if kernels.overlaps(out, x):
            raise ValueError("out must not overlap x")
    name = "dia_spmv_wide" if b is None else "dia_residual_wide"
    rc = kernels.lib().tpuamg_dia_tiles(
        head, x.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), THREADS, kernels.stream_ptr())
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out
