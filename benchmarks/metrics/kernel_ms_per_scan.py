"""Device time of the port's own hand-written kernels (K1-K10 by device
symbol) over the traced slice, per scan."""

from benchmarks import trace

UNIT = "ms"


def read(r):
    sl = r.slice
    if sl is None:
        return None
    own = [e - s for name, s, e in sl.kernels
           if trace.own_kernel(name) is not None]
    if not own:
        return None
    return sum(own) * 1e-6 / sl.scans
