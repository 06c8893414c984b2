"""Build, load and call the native amgkit library (C++ host setup kernels).

``amgkit.cpp`` (a copy of the JAX package's) holds the C++ routes of the
setup's graph work: COO coalescing, SpGEMM, greedy coloring, VMB
aggregation, heavy-edge matching and the ordered MIS.  At first use one
``g++ -O3 -fPIC -shared`` call compiles it into ``_build/``, under a name
that hashes the source and flags (a stale library is never loaded); the
build writes a temporary file and renames it into place, as
``kernels.py`` does for the CUDA library.  Nothing is built at import.

Every wrapper returns None when the library is unavailable, and its
caller then takes the numpy route.  On a machine with a CUDA card a
failed build raises instead: there the native routes are the ones the
solve is meant to take, and a silent switch to numpy would change the
aggregates and colors.  ``TPUAMG_NO_NATIVE`` selects the numpy routes at
the call sites that honour it (SpGEMM, coloring, VMB and MIS), as in the
JAX package.

The two routes build *different* (both valid) aggregates and colors, so
the port matches the JAX package only when both take the same route.

``tailkit.cpp`` (also a copy) is the host tail's V-cycle executor; it
builds the same way, with OpenMP, into its own library
(``native/tail.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "amgkit.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")
BUILD_TIMEOUT_S = 300

# what the last build did: {"seconds", "library", "cached"}
BUILD_INFO: dict = {}

_lib = None
_failed = None


def library_path(source=SOURCE, flags=CXX_FLAGS) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source=SOURCE, flags=CXX_FLAGS, info=BUILD_INFO) -> Path:
    """Compile one source (amgkit.cpp by default) into _build/ (skipped
    when the library for this exact source and these flags exists);
    raises on failure.  Fills info."""
    import time
    out = library_path(source, flags)
    if out.is_file():
        info.update(seconds=0.0, library=str(out), cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}-{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    try:
        p = subprocess.run(["g++", *flags, "-o", str(tmp), str(source)],
                           capture_output=True, text=True,
                           timeout=BUILD_TIMEOUT_S)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed ({p.returncode}):\n{p.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    info.update(seconds=time.perf_counter() - t0, library=str(out),
                cached=False)
    return out


def _card_present() -> bool:
    import torch
    return torch.cuda.is_available()


def get_lib():
    """The loaded library (built at first call); None where it cannot be
    built or loaded and no CUDA card is present.  With a card, a failure
    raises RuntimeError."""
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed is None:
        try:
            lib = ctypes.CDLL(str(build()))
        except Exception as e:      # no compiler, a compile error, ...
            _failed = e
        else:
            _bind(lib)
            _lib = lib
            return _lib
    if _card_present():
        raise RuntimeError(f"the native amgkit library did not build or "
                           f"load: {_failed}") from _failed
    return None


def _bind(lib):
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.coo_to_csr.argtypes = [ctypes.c_int64, ctypes.c_int64,
                               i64p, i64p, f64p, i64p, i32p, f64p]
    lib.coo_to_csr.restype = ctypes.c_int64
    lib.csr_spgemm_count.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                     i64p, i32p, i64p, i32p, i64p]
    lib.csr_spgemm_count.restype = None
    lib.csr_spgemm_fill.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                    i64p, i32p, f64p, i64p, i32p, f64p,
                                    i64p, i32p, f64p]
    lib.csr_spgemm_fill.restype = None
    lib.greedy_color.argtypes = [ctypes.c_int64, i64p, i32p,
                                 ctypes.c_int32, i32p]
    lib.greedy_color.restype = None
    lib.vmb_aggregation.argtypes = [ctypes.c_int64, i64p, i32p,
                                    ctypes.c_int64, i64p]
    lib.vmb_aggregation.restype = ctypes.c_int64
    lib.hem_matching.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                 i64p, i32p, f64p, i64p]
    lib.hem_matching.restype = ctypes.c_int64
    lib.greedy_mis.argtypes = [ctypes.c_int64, i64p, i32p, u8p, u8p]
    lib.greedy_mis.restype = ctypes.c_int64


# -- numpy-facing wrappers (None: take the numpy route) ---------------------

def native_spgemm(A, B):
    """C = A @ B via native Gustavson; returns HostCSR or None."""
    lib = get_lib()
    if lib is None:
        return None
    from ..sparse.host import HostCSR
    n, _ = A.shape
    _, m = B.shape
    c_indptr = np.zeros(n + 1, dtype=np.int64)
    a_ip = np.ascontiguousarray(A.indptr, dtype=np.int64)
    a_ix = np.ascontiguousarray(A.indices, dtype=np.int32)
    b_ip = np.ascontiguousarray(B.indptr, dtype=np.int64)
    b_ix = np.ascontiguousarray(B.indices, dtype=np.int32)
    lib.csr_spgemm_count(n, m, a_ip, a_ix, b_ip, b_ix, c_indptr)
    nnz = int(c_indptr[-1])
    c_ix = np.empty(nnz, dtype=np.int32)
    c_dt = np.empty(nnz, dtype=np.float64)
    lib.csr_spgemm_fill(n, m, a_ip, a_ix,
                        np.ascontiguousarray(A.data, dtype=np.float64),
                        b_ip, b_ix,
                        np.ascontiguousarray(B.data, dtype=np.float64),
                        c_indptr, c_ix, c_dt)
    return HostCSR(c_indptr, c_ix, c_dt, (n, m))


def native_coo_to_csr(rows, cols, vals, shape):
    """COO -> canonical coalesced CSR (duplicates summed); None if the
    library is unavailable.  Returns (indptr, indices, data)."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(shape[0])
    nnz = len(rows)
    indptr = np.empty(n + 1, dtype=np.int64)
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float64)
    w = lib.coo_to_csr(n, nnz,
                       np.ascontiguousarray(rows, dtype=np.int64),
                       np.ascontiguousarray(cols, dtype=np.int64),
                       np.ascontiguousarray(vals, dtype=np.float64),
                       indptr, out_cols, out_vals)
    return indptr, out_cols[:w].copy(), out_vals[:w].copy()


def native_greedy_color(A, max_colors=24):
    lib = get_lib()
    if lib is None:
        return None
    n = A.shape[0]
    colors = np.empty(n, dtype=np.int32)
    lib.greedy_color(n, np.ascontiguousarray(A.indptr, dtype=np.int64),
                     np.ascontiguousarray(A.indices, dtype=np.int32),
                     max_colors, colors)
    return colors


def native_vmb(S, max_aggregation=100):
    lib = get_lib()
    if lib is None:
        return None
    n = S.shape[0]
    agg = np.empty(n, dtype=np.int64)
    nagg = lib.vmb_aggregation(
        n, np.ascontiguousarray(S.indptr, dtype=np.int64),
        np.ascontiguousarray(S.indices, dtype=np.int32),
        max_aggregation, agg)
    return agg, int(nagg)


def native_hem(S):
    """Serial greedy HEM (quality-optimal ordering). Returns match array."""
    lib = get_lib()
    if lib is None:
        return None
    n = S.shape[0]
    rows = np.ascontiguousarray(S.rows_expanded(), dtype=np.int64)
    match = np.empty(n, dtype=np.int64)
    lib.hem_matching(n, S.nnz, rows,
                     np.ascontiguousarray(S.indices, dtype=np.int32),
                     np.ascontiguousarray(S.data, dtype=np.float64),
                     match)
    return match


def native_mis(G, candidates):
    lib = get_lib()
    if lib is None:
        return None
    n = G.shape[0]
    cand = np.zeros(n, dtype=np.uint8)
    cand[np.asarray(candidates)] = 1
    seed = np.empty(n, dtype=np.uint8)
    lib.greedy_mis(n, np.ascontiguousarray(G.indptr, dtype=np.int64),
                   np.ascontiguousarray(G.indices, dtype=np.int32),
                   cand, seed)
    return np.flatnonzero(seed).astype(np.int64)
