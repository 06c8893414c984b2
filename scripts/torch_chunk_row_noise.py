"""The f32 noise in the stats rows 0-1 of a PCG chunk, n=32.

tests/test_torch_gpu.py holds the card's chunk to the plain chunk
(pcg_chunk_plain) on stats rows 0-1 (alpha, beta, sqrt|rz|, ||r||, ||x||)
at n=32, gamma 1e6 and 1: the first chunk (from x = 0) and a second one
(from the state after the first, rz carried).  This script measures, for
each, how far those rows move when only the rounding changes, which sets
the limits the test can hold:

  fused updates   x + alpha p and r - alpha q rounded once (as an FMA)
  q in f64        q = Q p accumulated in float64, rounded once
  cycle noise     1e-7 relative noise on every cycle's z (--draws draws)
  z0 noise        1e-7 relative noise on the chunk's starting z
                  (--draws draws)
  control         a cycle whose z is 5e-4 too large: a real error

and, on a CUDA device, the persistent chunk (pcg_chunk, one launch) and
the sequenced chunk (pcg_chunk_sequenced) against the plain chunk.  Each
line gives the relative error over the rows (the test's row limit) and
the largest relative error of one entry (its per-entry limit), the
plain chunk without noise the reference; the starting z is shared
unless named.

    python scripts/torch_chunk_row_noise.py [--device cpu|cuda] [--draws 32]

Takes about a minute on the CPU; imports no JAX.
"""
import argparse
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 32
CHUNK = 4


def setup(dev, cycle, gamma):
    """The card test's system: bidomain 2D at n=32, metric_schwarz in f32,
    f32 planes.  Returns (fp, start), start() the first chunk's inputs."""
    from tpuamg_torch.amg.grid_fused import setup_grid_fused_pcg
    from tpuamg_torch.config import PRESETS
    from tpuamg_torch.fem import mms
    from tpuamg_torch.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, gamma)
    A, b, _, _ = get_system(get_mesh(N, 2), mms.setup_bidomain_mms(p, 2), p)
    prm = replace(PRESETS["metric_schwarz"], dtype="float32",
                  cycle_type=cycle)
    fp, slots, nflat = setup_grid_fused_pcg(A, (N + 1, N + 1), F=2,
                                            params=prm, device=dev)
    bk = torch.zeros(nflat, dtype=torch.float32)
    bk[torch.as_tensor(slots)] = torch.as_tensor(b, dtype=torch.float32)
    bm = bk.to(dev) * fp.vc.mask_flat
    z0 = fp.vc.matvec(bm).clone()

    def start():
        return (torch.zeros_like(bm), bm.clone(), torch.zeros_like(bm),
                z0.clone(), torch.full((1,), -1.0, device=dev))
    return fp, start


def chunk_variant(fp, x, r, p, z, rz_prev, fused=False, q64=False):
    """pcg_chunk_plain's iterations with one rounding changed; returns
    the stats rows."""
    from tpuamg_torch.amg.grid_fused import vcycle_plain
    from tpuamg_torch.sparse.dia_kernels import dia_spmv_plain
    Q = fp.Q
    st = torch.zeros((CHUNK + 1, 128), device=x.device)
    zero = torch.zeros((), device=x.device)
    rz_last = rz_prev.reshape(())
    for it in range(CHUNK):
        rz = torch.dot(r, z)
        beta = torch.where(rz_last > 0, rz / (rz_last + 1e-30), zero)
        if it:
            st[it - 1, 1] = beta
            st[it - 1, 2] = torch.sqrt(rz.abs())
        p = z + beta * p
        if q64:
            q = dia_spmv_plain(Q.offsets, Q.planes.double(),
                               p.double()).float()
        else:
            q = dia_spmv_plain(Q.offsets, Q.planes, p)
        alpha = rz / (torch.dot(p, q) + 1e-30)
        if fused:
            a64 = alpha.double()
            x.copy_((x.double() + a64 * p.double()).float())
            r.copy_((r.double() - a64 * q.double()).float())
        else:
            x.add_(alpha * p)
            r.sub_(alpha * q)
        st[it, 0] = alpha
        st[it, 3] = torch.linalg.vector_norm(r)
        st[it, 4] = torch.linalg.vector_norm(x)
        z = vcycle_plain(fp.vc, r).clone()
        rz_last = rz
    return st


def rows(st):
    return st[:2, :5].double().cpu().numpy()


def errs(a, ref):
    return (float(np.linalg.norm(a - ref) / np.linalg.norm(ref)),
            float(np.max(np.abs(a - ref) / np.abs(ref))))


def measure(fp, start, draws, dev):
    """{variant: (error over the rows, largest entry error)} of one chunk
    from start() against the plain chunk from it."""
    from tpuamg_torch.amg.grid_fused import (pcg_chunk, pcg_chunk_plain,
                                             pcg_chunk_sequenced,
                                             vcycle_plain)
    ref = rows(pcg_chunk_plain(fp, *start(), CHUNK)[4])
    out = {
        "fused updates": errs(rows(chunk_variant(fp, *start(), fused=True)),
                              ref),
        "q in f64": errs(rows(chunk_variant(fp, *start(), q64=True)), ref)}
    g = torch.Generator(device=dev).manual_seed(0)
    cyc, z0n = [], []
    for _ in range(draws):
        def noisy(vc, r):
            z = vcycle_plain(vc, r)
            return z * (1 + 1e-7 * torch.randn(z.shape, generator=g,
                                               device=dev))
        cyc.append(errs(rows(pcg_chunk_plain(fp, *start(), CHUNK,
                                             cycle=noisy)[4]), ref))
        x, r, p, z, rz = start()
        z = z * (1 + 1e-7 * torch.randn(z.shape, generator=g, device=dev))
        z0n.append(errs(rows(pcg_chunk_plain(fp, x, r, p, z, rz,
                                             CHUNK)[4]), ref))
    out["cycle noise, max"] = tuple(np.max(cyc, axis=0))
    out["z0 noise, max"] = tuple(np.max(z0n, axis=0))
    out["control"] = errs(rows(pcg_chunk_plain(
        fp, *start(), CHUNK, cycle=lambda vc, r: vcycle_plain(vc, r)
        * (1 + 5e-4))[4]), ref)
    if dev.type == "cuda":
        out["persistent"] = errs(rows(
            pcg_chunk(fp, *start(), CHUNK)[4].clone()), ref)
        out["sequenced"] = errs(rows(
            pcg_chunk_sequenced(fp, *start(), CHUNK)[4].clone()), ref)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--draws", type=int, default=32)
    args = ap.parse_args()
    from tpuamg_torch.amg.grid_fused import pcg_chunk_plain
    dev = torch.device(args.device)
    for gamma in (1e6, 1.0):
        for cycle in ("v", "w"):
            fp, start = setup(dev, cycle, gamma)
            # the second chunk starts where the plain first one ends
            x, r, p, z, st = (t.clone() for t in pcg_chunk_plain(
                fp, *start(), CHUNK))
            carry = st[CHUNK, 1:2].clone()

            def start2():
                return (x.clone(), r.clone(), p.clone(), z.clone(),
                        carry.clone())
            for which, fn in (("first", start), ("second", start2)):
                out = measure(fp, fn, args.draws, dev)
                for name, (rn, ent) in out.items():
                    print(f"gamma {gamma:g} {cycle} {which} chunk, {name}: "
                          f"rows {rn:.3e} entry {ent:.3e}", flush=True)


if __name__ == "__main__":
    main()
