from .relaxation import (JacobiSmoother, L1JacobiSmoother, ChebyshevSmoother,
                         MulticolorGS, build_jacobi, build_l1_jacobi,
                         build_multicolor_gs, build_chebyshev)
from .schwarz import SchwarzSmoother, build_schwarz, MetricSmoother

__all__ = ["JacobiSmoother", "L1JacobiSmoother", "ChebyshevSmoother",
           "MulticolorGS", "build_jacobi", "build_l1_jacobi",
           "build_multicolor_gs", "build_chebyshev",
           "SchwarzSmoother", "build_schwarz", "MetricSmoother"]
