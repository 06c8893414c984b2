from .cg import pcg, pcg_split, CGResult
from .minres import minres, MinresResult
from .gmres import gmres, GmresResult
