"""Native (C++/OpenMP) executor of the host-side float64 algebraic tail.

Counterpart of the JAX package's ``native/tail.py``.
``build_native_tail(prec)`` converts the port's ``MGPreconditioner``
(cycle 'v', maxit 1, UA transfers, float64 ELL levels: the .dat metric
tail) into a ``tailkit.cpp`` handle whose ``apply`` runs the same V-cycle
from CSR and ragged block data with OpenMP threads.

``tailkit.cpp`` (a copy of the JAX package's) is built at first use with
``g++ -O3 -march=native -fopenmp -fPIC -shared`` (the JAX package's
flags) into ``tpuamg_torch/_build/libtailkit-<hash>.so``, as amgkit is.
Without a card a failed build means no native tail; with a card it
raises.

It returns None, and logs one line saying why, for what the executor
does not cover: non-V cycles, maxit != 1, SA transfers, non-float64
levels, additive Schwarz and smoother types outside {MetricSmoother,
MulticolorGS, Chebyshev, Jacobi, Schwarz}; also under
``TPUAMG_NO_NATIVE`` or ``TPUAMG_NO_NATIVE_TAIL``.  The caller
(``amg.structured.HostTailHybrid``) then runs the tail as torch ops on
the CPU: the JAX package's rule, kept, but no longer silent.
"""
from __future__ import annotations

import ctypes
import logging
import os
from pathlib import Path

import numpy as np

from . import build

LOG = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "tailkit.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared")

SM_GS = 1
SM_METRIC_GS = 2
SM_SCHWARZ = 3
SM_CHEB = 4
SM_METRIC_CHEB = 5
SM_JACOBI = 6

# what the last build did: {"seconds", "library", "cached"}
BUILD_INFO: dict = {}

_lib = None
_failed = None


def get_lib():
    """The loaded tailkit library (built at first call); None where it
    cannot be built or loaded and no CUDA card is present.  With a card,
    a failure raises RuntimeError."""
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed is None:
        try:
            lib = ctypes.CDLL(str(build(SOURCE, CXX_FLAGS, BUILD_INFO)))
        except Exception as e:      # no compiler, a compile error, ...
            _failed = e
        else:
            _bind(lib)
            _lib = lib
            return _lib
    import torch
    if torch.cuda.is_available():
        raise RuntimeError(f"the native tailkit library did not build or "
                           f"load: {_failed}") from _failed
    return None


def _bind(lib):
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    c = ctypes
    lib.tk_create.restype = c.c_int64
    lib.tk_create.argtypes = []
    lib.tk_free.argtypes = [c.c_int64]
    lib.tk_free.restype = None
    lib.tk_set_opts.argtypes = [c.c_int64, c.c_int32, c.c_int32, c.c_int32]
    lib.tk_add_level.argtypes = [c.c_int64, c.c_int64, c.c_int64, i64p,
                                 i32p, f64p, i32p, c.c_int64]
    lib.tk_level_gs.argtypes = [c.c_int64, c.c_int64, c.c_int32, i64p, i32p,
                                f64p, c.c_double, c.c_int32]
    lib.tk_level_schwarz.argtypes = [c.c_int64, c.c_int64, c.c_int64, i64p,
                                     i32p, i64p, f64p, i32p, c.c_int32,
                                     c.c_double, c.c_int32]
    lib.tk_level_cheb.argtypes = [c.c_int64, c.c_int64, f64p, c.c_double,
                                  c.c_double, c.c_int32]
    lib.tk_level_jacobi.argtypes = [c.c_int64, c.c_int64, f64p, c.c_double]
    lib.tk_level_kind.argtypes = [c.c_int64, c.c_int64, c.c_int32]
    lib.tk_set_coarse.argtypes = [c.c_int64, c.c_int64, f64p]
    lib.tk_apply.argtypes = [c.c_int64, f64p, f64p]
    for name in ("tk_set_opts", "tk_add_level", "tk_level_gs",
                 "tk_level_schwarz", "tk_level_cheb", "tk_level_jacobi",
                 "tk_level_kind", "tk_set_coarse", "tk_apply"):
        getattr(lib, name).restype = None


class NativeTail:
    """Owns one tailkit handle; apply(rc) -> ec, both float64 numpy."""

    def __init__(self, handle, n0, lib):
        self._h = handle
        self.n0 = n0
        self._lib = lib

    def apply(self, rc):
        rc = np.ascontiguousarray(rc, dtype=np.float64)
        if len(rc) != self.n0:
            raise ValueError(f"tail input of {len(rc)} entries, expected "
                             f"{self.n0}")
        out = np.empty(self.n0, dtype=np.float64)
        self._lib.tk_apply(self._h, rc, out)
        return out

    def __del__(self):
        try:
            self._lib.tk_free(self._h)
        except Exception:       # interpreter shutdown
            pass


class _Unsupported(Exception):
    pass


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else \
        np.asarray(t)


def _f64(a):
    return np.ascontiguousarray(_np(a), dtype=np.float64)


def _i32(a):
    return np.ascontiguousarray(_np(a), dtype=np.int32)


def _i64(a):
    return np.ascontiguousarray(_np(a), dtype=np.int64)


def _attach_gs(lib, h, lvl, gs):
    ids_all, invd_all, cptr = [], [], [0]
    for ids, invd in zip(gs.color_ids, gs.color_invd):
        ids_all.append(_i32(ids))
        invd_all.append(_f64(invd))
        cptr.append(cptr[-1] + len(ids_all[-1]))
    lib.tk_level_gs(h, lvl, len(cptr) - 1, _i64(cptr),
                    np.concatenate(ids_all) if ids_all else
                    np.empty(0, np.int32),
                    np.concatenate(invd_all) if invd_all else
                    np.empty(0, np.float64),
                    float(gs.omega), int(bool(gs.symmetric)))


def _attach_schwarz(lib, h, lvl, sw, n):
    if getattr(sw, "additive", False):
        raise _Unsupported("additive Schwarz")
    ids_all, inv_all, colors = [], [], []
    bptr, fptr = [0], [0]
    for c, (ids_c, inv_c) in enumerate(zip(sw.dof_ids, sw.inv_blocks)):
        ids_c = _np(ids_c)
        inv_c = _f64(inv_c)
        for bk in range(ids_c.shape[0]):
            row = ids_c[bk]
            sz = int(np.sum(row < n))
            if sz == 0:
                continue
            if np.any(row[:sz] >= n):      # the padding must trail
                raise _Unsupported("non-trailing block padding")
            ids_all.append(_i32(row[:sz]))
            inv_all.append(
                np.ascontiguousarray(inv_c[bk, :sz, :sz]).reshape(-1))
            colors.append(c)
            bptr.append(bptr[-1] + sz)
            fptr.append(fptr[-1] + sz * sz)
    lib.tk_level_schwarz(
        h, lvl, len(colors), _i64(bptr),
        np.concatenate(ids_all) if ids_all else np.empty(0, np.int32),
        _i64(fptr),
        np.concatenate(inv_all) if inv_all else np.empty(0, np.float64),
        _i32(colors), len(sw.dof_ids), float(sw.weight),
        int(bool(sw.symmetric)))


def _attach_smoother(lib, h, lvl, sm, n):
    from ..smoothers import (ChebyshevSmoother, JacobiSmoother,
                             MetricSmoother, MulticolorGS, SchwarzSmoother)
    if isinstance(sm, MetricSmoother):
        _attach_schwarz(lib, h, lvl, sm.schwarz, n)
        if sm.gs is None:
            lib.tk_level_kind(h, lvl, SM_SCHWARZ)
        elif isinstance(sm.gs, MulticolorGS):
            _attach_gs(lib, h, lvl, sm.gs)
            lib.tk_level_kind(h, lvl, SM_METRIC_GS)
        elif isinstance(sm.gs, ChebyshevSmoother):
            lib.tk_level_cheb(h, lvl, _f64(sm.gs.invd), float(sm.gs.lmax),
                              float(sm.gs.lmin), int(sm.gs.degree))
            lib.tk_level_kind(h, lvl, SM_METRIC_CHEB)
        else:
            raise _Unsupported(type(sm.gs).__name__)
    elif isinstance(sm, SchwarzSmoother):
        _attach_schwarz(lib, h, lvl, sm, n)
        lib.tk_level_kind(h, lvl, SM_SCHWARZ)
    elif isinstance(sm, MulticolorGS):
        _attach_gs(lib, h, lvl, sm)
        lib.tk_level_kind(h, lvl, SM_GS)
    elif isinstance(sm, ChebyshevSmoother):
        lib.tk_level_cheb(h, lvl, _f64(sm.invd), float(sm.lmax),
                          float(sm.lmin), int(sm.degree))
        lib.tk_level_kind(h, lvl, SM_CHEB)
    elif isinstance(sm, JacobiSmoother):   # covers L1JacobiSmoother
        lib.tk_level_jacobi(h, lvl, _f64(sm.invd), float(sm.omega))
        lib.tk_level_kind(h, lvl, SM_JACOBI)
    else:
        raise _Unsupported(type(sm).__name__)


def _why_not(prec):
    """Why the executor cannot run prec, or None when it can."""
    if os.environ.get("TPUAMG_NO_NATIVE") \
            or os.environ.get("TPUAMG_NO_NATIVE_TAIL"):
        return "TPUAMG_NO_NATIVE / TPUAMG_NO_NATIVE_TAIL is set"
    if prec.cycle != "v" or prec.maxit != 1:
        return f"cycle {prec.cycle!r} with maxit {prec.maxit} (V, 1 only)"
    return None


def build_native_tail(prec):
    """The port's MGPreconditioner -> NativeTail, or None (with one log
    line saying why) when the executor does not cover it."""
    import torch
    why = _why_not(prec)
    lib = None
    if why is None:
        lib = get_lib()
        if lib is None:
            why = f"the tailkit library did not build: {_failed}"
    if why is not None:
        LOG.warning("host tail: torch ops on the CPU, not the native "
                    "executor (%s)", why)
        return None
    h = lib.tk_create()
    try:
        for lvl, L in enumerate(prec.levels):
            if getattr(L, "agg", None) is None:
                raise _Unsupported("SA transfers" if hasattr(L, "P")
                                   else type(L).__name__)
            if L.A.dtype != torch.float64:
                # the tail contract is f64; narrower levels would silently
                # change the preconditioner
                raise _Unsupported(f"a {L.A.dtype} level")
            A = L.A.to_host()
            n = A.shape[0]
            lib.tk_add_level(h, n, A.nnz, _i64(A.indptr), _i32(A.indices),
                             _f64(A.data), _i32(L.agg), int(L.nc))
            _attach_smoother(lib, h, lvl, L.smoother, n)
        cinv = _f64(prec.coarse_inv)
        lib.tk_set_coarse(h, cinv.shape[0], cinv.reshape(-1))
        lib.tk_set_opts(h, int(prec.presmooth), int(prec.postsmooth),
                        int(bool(prec.coarse_scaling)))
    except _Unsupported as e:
        lib.tk_free(h)
        LOG.warning("host tail: torch ops on the CPU, not the native "
                    "executor (%s)", e)
        return None
    n0 = prec.levels[0].A.shape[0] if prec.levels else cinv.shape[0]
    return NativeTail(h, n0, lib)
