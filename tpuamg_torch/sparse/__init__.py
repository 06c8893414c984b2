from .host import HostCSR, bmat, rap
