"""Build, load and call the package's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use, one
``nvcc`` per source, all started together, compiles them for Hopper
(``sm_90a``), and one more links them into one shared library under
``_build/``, named by a hash of the sources and flags, so a stale library
is never loaded; the build writes temporary files and renames the
library into place, and takes no lock.  The library is loaded with ``ctypes``.
Nothing is built or loaded at import: the CPU paths never need a CUDA
toolchain.

Every C entry launches on PyTorch's current stream, allocates nothing and
returns ``cudaGetLastError()``; :func:`check` raises on a nonzero code.
Every wrapper that launches a kernel adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300

LANES = 128
MAX_DIAGS = 64      # kMaxDiags of csrc/dia_sweep.cuh and cycle_program.cuh

# launches per wrapper name, for showing that a run went through the kernels
LAUNCHES: Counter = Counter()

# what the last build did: {"seconds", "library", "ptxas", "cached"}
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "tpuamg_dia_sweep": (_P, _I, _P, _P, _P, _LL, _I, _P, _P),
    "tpuamg_dia_sweep_pad": (_P, _I, _P, _LL, _P, _P, _LL, _I, _P, _P),
    "tpuamg_dia_sweep_wide": (_P, _I, _P, _P, _P, _LL, _I, _P, _P),
    "tpuamg_dia_tiles": (_P, _P, _P, _P, _I, _P),
    "tpuamg_cheb_step": (_P, _I, _I, _P, _P, _I, _I, _P, _P, _LL, _P, _P,
                         _P, _P, _LL, _I, _I, _F, _F, _P),
    "tpuamg_cheb_apply": (_P, _I, _P, _P, _P, _LL, _I, _P, _I, _F, _F, _P),
    "tpuamg_restrict": (_P, _P, _LL, _I, _P, _I, _I, _I, _P),
    "tpuamg_prolong": (_P, _P, _I, _P, _LL, _I, _P, _I, _I, _I, _P),
    "tpuamg_coarse_gemv": (_P, _I, _P, _P, _I, _I, _I, _P),
    "tpuamg_coarse_reduce": (_P, _P, _I, _I, _P),
    "tpuamg_cheb_sweep": (_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                          _P, _LL, _I, _I, _F, _P, _P),
    "tpuamg_pcg_rz": (_P, _P, _P, _LL, _P),
    "tpuamg_pcg_pq": (_P, _I, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _I,
                      _P, _P),
    "tpuamg_pcg_xr": (_P, _P, _P, _P, _LL, _P, _P, _I, _P, _P, _P),
    "tpuamg_pcg_finish": (_P, _P, _LL, _P, _I, _P, _P),
    "tpuamg_pcg_persistent": (_P, _I, _P, _I, _I, _I, _I, _P),
    "tpuamg_pcg_persistent_occupancy": (_I, _I, _P),
    "tpuamg_pcg_persistent_layout": (_P,),
    "tpuamg_cycle_persistent": (_P, _I, _I, _I, _I, _P),
    "tpuamg_cycle_persistent_occupancy": (_I, _I, _P),
    "tpuamg_cycle_persistent_layout": (_P,),
    "tpuamg_cheb_persistent": (_P, _I, _I, _I, _I, _P),
    "tpuamg_cheb_persistent_occupancy": (_I, _I, _P),
    "tpuamg_cheb_persistent_layout": (_P,),
}

_lib = None


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one, that is an error: the CPU
    runs only when the caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtpuamg_kernels-{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the nvcc commands side by side; returns their logs in order.
    Each runs in its own process group, so a timeout stops its children
    too; any failure raises."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for c in cmds]
    logs, failed = [], []
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    try:
        for c, proc in zip(cmds, procs):
            log, _ = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"{' '.join(c)} ({proc.returncode}):\n{log}")
    except subprocess.TimeoutExpired:
        failed.append(f"nvcc timed out after {NVCC_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return logs


def build() -> Path:
    """Compile csrc/*.cu for Hopper, one nvcc per source, all started
    together, then link them into one library (skipped when the library
    for these exact sources exists).  Fills BUILD_INFO."""
    out = library_path()
    if out.is_file():
        BUILD_INFO.update(seconds=0.0, library=str(out), ptxas="",
                          cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}-{os.getpid()}"
    tmp = out.with_name(f".{tag}.tmp.so")
    cu, _ = _sources()
    objs = [BUILD_DIR / f".{tag}-{f.stem}.o" for f in cu]
    t0 = time.perf_counter()
    try:
        logs = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
                     for f, o in zip(cu, objs)])
        _run([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(out),
                      ptxas="".join(logs), cached=False)
    return out


def lib():
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def int_array(values: tuple):
    """A ctypes int array of the values (kept alive by the cache)."""
    return (ctypes.c_int * max(len(values), 1))(*values)


def storage_flag(t: torch.Tensor) -> int:
    """0 for float32, 1 for bfloat16: the plane types the kernels take."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel storage must be float32 or bfloat16, "
                    f"not {t.dtype}")


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory of two contiguous tensors overlaps."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def require(t: torch.Tensor, name: str, *, dtype=None, numel=None,
            device=None):
    """Raise unless t is a contiguous CUDA tensor of the given properties."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} elements, expected {numel}")
