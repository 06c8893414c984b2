#!/usr/bin/env python3
"""K1's wide entry on the structured 3D-1D route's AD, timed on one CUDA
card at the route's sizes.

For each configuration, the script dumps the 3D-1D system with the port's
``emi_3d1d -dump 1`` (host numpy) and builds only the factored outer
operator's AD, as ``run_solver_3d1d``'s structured route does: the tiled
slot order (``lattice_tiled_slots``) and ``_split_metric_operator``
(float32 storage, a ``KernelDIA``), without the hierarchy or the host
tail.  Configurations (gamma 1; AD's band structure does not depend on
it):

    16  radius 0.2, the default synthetic neuron (chip_smoke.py phase 21)
    32  radius 0.2, the default synthetic neuron
    64  radius 0.05, the neuron -n_main 2400 -n_branches 48 -nseg 4
        (scripts/torch_3d1d_scale.py's production size)

Per configuration it prints AD's shape (bands, rows, stored plane
entries, nonzeros, fill), the tile layout (bands per tile, entries with
their padding, index width, build seconds), and then, for y = AD x and
y = b - AD x, by CUDA events (200 back-to-back calls) and by profiler
device time (warm L2, and after a 128 MB write, cold L2):

    tiles   the wide entry (csrc/dia_tiles.cu), the route's kernel;
    planes  the earlier wide design (csrc/dia.cu dia_wide_kernel), which
            reads every padded plane;
    csr     torch.sparse CSR @ / addmv on the same operator (a yardstick
            the port never calls);

timed in turns (planes, tiles, tiles, planes), beside the bound: the
nonzero values, x and y (and b) once over 3.35 TB/s, with the padded
planes' bytes as a second figure.  Layout variants (tile rows 32/64/128,
64/128/256 threads a block) are timed by events and warm device time.
Checks: one matvec against the host CSR in float64 (1e-5 relative), the
wide entry equal to the planes design bit for bit, and the layout's walk
on the card.  It exits nonzero without a card or when a check fails.

    python3 scripts/torch_wide_dia.py [mesh_n ...]     (default 16 32 64)
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (data sheet)
CONFIGS = {16: ("0.2", []), 32: ("0.2", []),
           64: ("0.05", ["-n_main", "2400", "-n_branches", "48", "-nseg",
                         "4"])}
VARIANTS = ((32, 64), (32, 128), (32, 256), (64, 64), (128, 128))
REPS = 200


def say(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi():
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() else \
            f"nvidia-smi gave nothing (rc {p.returncode})"
    except Exception as e:      # noqa: BLE001 - report, do not fail
        return f"nvidia-smi failed: {e}"


def build_ad(mesh_n, tmp, dev):
    """AD of the configuration's dump, a KernelDIA on dev."""
    from tpuamg_torch.amg.structured import lattice_tiled_slots
    from tpuamg_torch.io_utils import load_coupling, load_system
    from tpuamg_torch.problems import emi_3d1d
    from tpuamg_torch.problems.solve import _split_metric_operator
    radius, curve = CONFIGS[mesh_n]
    d = os.path.join(tmp, f"dump{mesh_n}") + "/"
    t0 = time.perf_counter()
    check(emi_3d1d.main(["-gamma", "1", "-radius", radius, "-dump", "1",
                         "-outdir", d, "-mesh_n", str(mesh_n)] + curve)
          == 0, "emi_3d1d -dump 1 failed")
    t_dump = time.perf_counter() - t0
    A, b, idofs, idofs3d, coords = load_system(d, with_coords=True)
    sizes = (len(idofs3d), len(b) - len(idofs3d))
    slots, nsl = lattice_tiled_slots(np.asarray(coords, dtype=np.float64),
                                     idofs, A.shape[0])
    t0 = time.perf_counter()
    op = _split_metric_operator(A, load_coupling(d), sizes, slots, nsl,
                                torch.float32, None, dev)
    t_op = time.perf_counter() - t0
    say(f"[{mesh_n} system] radius {radius} {' '.join(curve) or 'default'}"
        f" neuron: {len(b)} dofs, {nsl} slots | dump {t_dump:.2f} s, "
        f"AD {t_op:.2f} s")
    return op.AD


def events_ms(fn, reps=REPS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_us(fn, keep, cold, reps=20):
    """Profiler device time per call (us) of the kernels whose name keep()
    accepts; cold: each call after a 128 MB write.  None where the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if cold:
                flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and keep(ev.name))
    return us / reps if us > 0 else None


def csr_of(H, dev):
    return torch.sparse_csr_tensor(
        torch.as_tensor(H.indptr, dtype=torch.int64),
        torch.as_tensor(H.indices.astype(np.int64)),
        torch.as_tensor(H.data, dtype=torch.float32), size=H.shape).to(dev)


def launch_raw(tiles, x, b, out, threads):
    """One launch of the wide kernel with a given block size (variants)."""
    from tpuamg_torch import kernels
    rc = kernels.lib().tpuamg_dia_tiles(
        tiles.kernel_args(), x.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), threads,
        kernels.stream_ptr())
    kernels.check(rc, "dia_tiles (variant)")


def fmt(v, unit="us"):
    return "not measured" if v is None else f"{v:.3f} {unit}"


def measure(mesh_n, AD, H, dev):
    from tpuamg_torch.sparse.dia_kernels import (dia_spmv_plain,
                                                 dia_spmv_wide_planes,
                                                 offsets_tensor)
    from tpuamg_torch.sparse.dia_tiles import (build_tiles, dia_spmv_tiles,
                                               dia_tiles_plain)
    n, nd = AD.shape[0], len(AD.offsets)
    planes, offs = AD.planes, AD.offsets
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiles = AD.tiles()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    per_tile = (tiles.band_ptr[1:] - tiles.band_ptr[:-1]).float()
    item = planes.element_size()
    say(f"[{mesh_n} AD] {nd} bands, offsets {min(offs)}..{max(offs)}, "
        f"{n} rows, {planes.numel()} stored plane entries, {tiles.nnz} "
        f"nonzeros (fill {tiles.nnz / planes.numel():.4f}) | layout: "
        f"{tiles.rows}-row tiles, bands per tile mean "
        f"{float(per_tile.mean()):.1f} max {tiles.max_bands}, "
        f"{tiles.vals.numel()} entries with padding "
        f"({tiles.vals.numel() / max(tiles.nnz, 1):.3f}x the nonzeros), "
        f"uint{8 * tiles.idx_bytes} indices, {tiles.stream_bytes()} B a "
        f"walk, built in {t_build:.3f} s")
    rng = np.random.default_rng(mesh_n)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=dev)
    bb = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
    # checks: float64 CSR, the planes design bit for bit, the walk
    y = AD.matvec(x)
    y64 = H.matvec(x.double().cpu().numpy())
    rel64 = float(np.abs(y.double().cpu().numpy() - y64).max()
                  / np.abs(y64).max())
    check(rel64 <= 1e-5, f"mesh_n {mesh_n}: AD x vs float64 CSR {rel64:.3e}")
    offs_dev = offsets_tensor(offs, dev)
    check(torch.equal(y, dia_spmv_wide_planes(offs, planes, x,
                                              offsets_dev=offs_dev)),
          f"mesh_n {mesh_n}: tiles and planes designs differ")
    walk = dia_tiles_plain(tiles, x)
    plain = dia_spmv_plain(offs, planes, x)
    rel_w = float((walk - plain).abs().max() / plain.abs().max())
    rel_k = float((y - plain).abs().max() / plain.abs().max())
    check(rel_w <= 1e-6 and rel_k <= 1e-5,
          f"mesh_n {mesh_n}: walk {rel_w:.3e}, kernel {rel_k:.3e} vs plain")
    say(f"[{mesh_n} check] vs float64 CSR {rel64:.3e}; = planes design "
        f"bit for bit; kernel vs plain {rel_k:.3e}; walk on the card vs "
        f"plain {rel_w:.3e}")
    M = csr_of(H, dev)
    rows = {}
    out = torch.empty_like(x)
    for form, rhs in (("matvec", None), ("residual", bb)):
        calls = {
            "tiles": lambda rhs=rhs: dia_spmv_tiles(tiles, x, rhs, out),
            "planes": lambda rhs=rhs: dia_spmv_wide_planes(
                offs, planes, x, rhs, out, offs_dev),
            "csr": (lambda: M @ x) if rhs is None else
            (lambda: torch.addmv(bb, M, x, beta=1.0, alpha=-1.0))}
        keep = {"tiles": lambda k: "dia_tiles_kernel" in k,
                "planes": lambda k: "dia_wide_kernel" in k,
                "csr": lambda k: "FillFunctor" not in k}
        ev = {k: [] for k in calls}
        for k in ("planes", "tiles", "tiles", "planes", "csr"):
            ev[k].append(events_ms(calls[k]))
        nb = 4 * n * (2 + (rhs is not None))
        bound = (tiles.nnz * item + nb) / HBM_BYTES_PER_S * 1e3
        padded = (planes.numel() * item + nb) / HBM_BYTES_PER_S * 1e3
        row = dict(bound_ms=bound, bound_bytes=tiles.nnz * item + nb,
                   padded_bound_ms=padded,
                   padded_bytes=planes.numel() * item + nb)
        for k in calls:
            warm = device_us(calls[k], keep[k], False)
            cold = device_us(calls[k], keep[k], True)
            row[k] = dict(events_ms=ev[k], warm_us=warm, cold_us=cold)
            share = "" if warm is None else (
                f", {bound * 1e3 / warm:.3f} / "
                f"{'-' if cold is None else f'{bound * 1e3 / cold:.3f}'} of "
                f"the bound warm / cold")
            say(f"[{mesh_n} {form} {k}] events "
                f"{'/'.join(f'{t:.5f}' for t in ev[k])} ms | device "
                f"{fmt(warm)} warm, {fmt(cold)} cold{share}")
        say(f"[{mesh_n} {form} bound] {bound * 1e3:.3f} us (bytes: "
            f"{row['bound_bytes']} B of nonzero values, x, y"
            f"{', b' if rhs is not None else ''}); padded planes "
            f"{padded * 1e3:.3f} us ({row['padded_bytes']} B)")
        rows[form] = row
    var = []
    for T, threads in VARIANTS:
        tl = tiles if T == tiles.rows else build_tiles(offs, planes, T)
        fn = (lambda tl=tl, th=threads: launch_raw(tl, x, None, out, th))
        fn()
        check(torch.equal(out, y), f"variant T={T} threads={threads}")
        ms = events_ms(fn)
        warm = device_us(fn, lambda k: "dia_tiles_kernel" in k, False)
        var.append(dict(rows=T, threads=threads, entries=tl.vals.numel(),
                        max_bands=tl.max_bands, events_ms=ms, warm_us=warm))
        say(f"[{mesh_n} variant] {T}-row tiles, {threads} threads: "
            f"{tl.vals.numel()} entries, max {tl.max_bands} bands a tile, "
            f"events {ms:.5f} ms, device {fmt(warm)} warm")
    return dict(mesh_n=mesh_n, bands=nd, rows=n,
                plane_entries=planes.numel(), nnz=tiles.nnz,
                entries=tiles.vals.numel(), max_bands=tiles.max_bands,
                mean_bands=float(per_tile.mean()),
                idx_bytes=tiles.idx_bytes, build_s=t_build, forms=rows,
                variants=var)


def main(argv):
    if not torch.cuda.is_available():
        say("no CUDA device: this script times kernels on the card")
        return 1
    meshes = [int(a) for a in argv] or sorted(CONFIGS)
    dev = torch.device("cuda")
    from tpuamg_torch import kernels
    kernels.lib()
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for mesh_n in meshes:
            AD = build_ad(mesh_n, tmp, dev)
            H = AD.to_host()
            out.append(measure(mesh_n, AD, H, dev))
            del AD, H
            torch.cuda.empty_cache()
    smi = nvidia_smi()
    say(smi)
    say(json.dumps({"device": smi, "configs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
