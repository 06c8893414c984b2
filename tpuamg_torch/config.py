"""Configuration dataclasses: AMG parameters, their presets and the outer
Krylov configuration.

Copy of the JAX package's ``config.py``: the same fields, defaults and
canned presets, keyed by the names the drivers use, so a parameter set
means the same hierarchy in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class AMGParameters:
    """Mirror of the haznics AMG parameter surface (reference
    amg_parameters.py:3-89, utils.py:20-38,60-82)."""
    amg_type: str = "ua"              # ua | sa            (UA_AMG/SA_AMG)
    cycle_type: str = "w"        # v | w | amli | nl_amli | add | fmg
    max_levels: int = 20
    maxit: int = 1                    # cycles per preconditioner apply
    smoother: str = "sgs"    # jacobi|l1_jacobi|gs|sgs|sor|ssor|chebyshev
    relaxation: float = 1.2
    presmooth_iter: int = 1
    postsmooth_iter: int = 1
    coarse_dof: int = 100
    coarse_solver: str = "dense"      # dense LU == UMFPACK role (32)
    coarse_scaling: bool = True
    aggregation_type: str = "vmb"     # vmb | hem | mis | mwm | hec
    strong_coupled: float = 0.1
    max_aggregation: int = 100
    amli_degree: int = 3
    # Schwarz smoother block (HAZmath Schwarz_*)
    schwarz_levels: int = 0           # levels 0..k-1 get Schwarz smoothing
    schwarz_mmsize: int = 100
    schwarz_maxlvl: int = 1
    schwarz_type: str = "symmetric"   # forward | backward | symmetric
    schwarz_blksolver: str = "dense"  # dense inverse == UMFPACK role
    schwarz_cluster: bool = False     # merge overlapping seed blocks
    # knobs with no reference analog
    dtype: str = "float64"            # compute dtype of the cycle
    pairwise_passes: int = 2          # HEM matchings per level (ratio ~2^k)
    max_w_work: int = 64              # cap on W/AMLI recursive visits;
    #                                   deeper levels degrade to V
    gs_max_colors: int = 24           # multicolor-GS color cap
    print_level: int = 0


# -- canned presets (parity with reference amg_parameters.py) --------------

# NL_AMLI(2) with coarse scaling is the h-robust standard-AMG baseline; the
# reference's W-cycle dict is kept as parameters_standard_reference.
parameters_standard = AMGParameters(
    amg_type="ua", cycle_type="nl_amli", amli_degree=2, max_levels=20,
    maxit=1, smoother="sgs",
    relaxation=1.2, coarse_dof=100, aggregation_type="vmb",
    strong_coupled=0.1, max_aggregation=100, schwarz_levels=0)

parameters_standard_schwarz = replace(
    parameters_standard, schwarz_levels=1, schwarz_mmsize=100,
    schwarz_maxlvl=1)

parameters_standard_reference = replace(
    parameters_standard, cycle_type="w", amli_degree=3)

parameters_metric = AMGParameters(
    amg_type="ua", cycle_type="w", max_levels=20, maxit=1, smoother="sgs",
    relaxation=1.2, coarse_dof=100, aggregation_type="hem",
    strong_coupled=0.1, amli_degree=3, schwarz_levels=0)

parameters_metric_schwarz = replace(
    parameters_metric, schwarz_levels=1, schwarz_mmsize=100,
    schwarz_maxlvl=1)

# default dict of get_hazmath_metric_precond_mono when None
# (reference utils.py:60-82): metric + Schwarz with maxlvl 2
parameters_metric_mono_default = replace(
    parameters_metric_schwarz, schwarz_maxlvl=2)

# smoothed aggregation + NL-AMLI(2) + clustered footprint Schwarz: the
# h-robust 3D-1D variant of the input_metric.dat configuration
parameters_metric_3d1d_hrobust = AMGParameters(
    amg_type="sa", cycle_type="nl_amli", amli_degree=2, max_levels=30,
    maxit=1, smoother="gs", relaxation=1.0, coarse_dof=300,
    aggregation_type="hem", strong_coupled=0.0, max_aggregation=20,
    schwarz_levels=1, schwarz_mmsize=500, schwarz_maxlvl=2,
    schwarz_cluster=True, pairwise_passes=2)

PRESETS = {
    "standard": parameters_standard,
    "standard_reference": parameters_standard_reference,
    "standard_schwarz": parameters_standard_schwarz,
    "metric": parameters_metric,
    "metric_schwarz": parameters_metric_schwarz,
    "metric_mono_default": parameters_metric_mono_default,
    "metric_3d1d_hrobust": parameters_metric_3d1d_hrobust,
}


@dataclass(frozen=True)
class SolverConfig:
    """Outer Krylov configuration (cbc.block ConjGrad surface,
    reference bidomain_2d.py:205)."""
    method: str = "cg"                # cg | minres | gmres
    tolerance: float = 1e-8
    maxiter: int = 500
    restart: int = 30                 # gmres only
    # HAZmath linear_stop_type codes (input_metric.dat:54):
    # 1 ||r||/||b||, 2 ||r||_B/||r0||_B (preconditioned), 3 ||r||/||x||
    stop_type: int = 2

