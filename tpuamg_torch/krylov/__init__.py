from .cg import pcg, CGResult
from .minres import minres, MinresResult
from .gmres import gmres, GmresResult
