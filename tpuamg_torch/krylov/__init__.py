from .cg import pcg, CGResult
