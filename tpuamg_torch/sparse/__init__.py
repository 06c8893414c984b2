from .host import HostCSR, bmat, rap, rap_unsmoothed, greedy_color
from .device import ELL, ell_rows, matvec_op
