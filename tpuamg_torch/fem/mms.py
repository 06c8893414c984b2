"""Method of Manufactured Solutions, derived with PyTorch autodiff.

The exact solution is written as a scalar torch function of one point; the
fluxes and forcings follow from ``torch.func.grad``/``torch.func.jacfwd``
in float64 on the CPU.  All evaluators returned here are numpy-in /
numpy-out, because they feed host-side assembly.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

# points per vmap call: keeps the batched autodiff intermediates small
_CHUNK = 1 << 18


def vectorize(f_point):
    """(gdim,) -> scalar or (k,)  ==>  (n, gdim) -> (n,) or (n, k) numpy
    evaluator, computed in float64 on the CPU."""
    fv = vmap(f_point)

    def call(pts):
        x = torch.as_tensor(np.asarray(pts, dtype=np.float64))
        with torch.no_grad():
            out = [fv(x[i:i + _CHUNK]) for i in range(0, len(x), _CHUNK)]
        if not out:
            return np.zeros((0,))
        return torch.cat(out).numpy()
    return call


def div(F):
    """Divergence of a vector field F: (g,) -> (g,)."""
    def d(x):
        return torch.trace(jacfwd(F)(x))
    return d


def setup_bidomain_mms(params, dim=2):
    """Exact data for the coupled bidomain system
        -div(kappa1 grad u1) + gamma (u1 - u2) = f1
        -div(kappa2 grad u2) + gamma (u2 - u1) = f2
    2D: u1 = cos(pi (x+y)), u2 = sin(pi (x-y))
        (reference bidomain_2d.py:21-22)
    3D: u1 = cos(pi (x+y+2z)), u2 = sin(pi (x-y+z))
        (reference bidomain_3d.py:21-22)
    Returns dict of numpy evaluators: u1, u2, grad_u1, grad_u2, flux1,
    flux2 (sigma_i = -kappa_i grad u_i), f1, f2.
    """
    k1, k2, g = float(params.kappa1), float(params.kappa2), float(params.gamma)
    pi = math.pi

    if dim == 2:
        def u1(x):
            return torch.cos(pi * (x[0] + x[1]))

        def u2(x):
            return torch.sin(pi * (x[0] - x[1]))
    else:
        def u1(x):
            return torch.cos(pi * (x[0] + x[1] + 2 * x[2]))

        def u2(x):
            return torch.sin(pi * (x[0] - x[1] + x[2]))

    def sigma1(x):
        return -k1 * grad(u1)(x)

    def sigma2(x):
        return -k2 * grad(u2)(x)

    def f1(x):
        return div(sigma1)(x) + g * (u1(x) - u2(x))

    def f2(x):
        return div(sigma2)(x) + g * (u2(x) - u1(x))

    return {
        "u1": vectorize(u1), "u2": vectorize(u2),
        "grad_u1": vectorize(grad(u1)),
        "grad_u2": vectorize(grad(u2)),
        "flux1": vectorize(sigma1), "flux2": vectorize(sigma2),
        "f1": vectorize(f1), "f2": vectorize(f2),
    }
