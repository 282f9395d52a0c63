"""Device-busy milliseconds per query over the profiled pass (the union of
kernel, copy and fill intervals): the device kernels."""

from ..trace import busy_s


def read(trace):
    p = trace.profile
    if p is None or not p.queries or not p.device:
        return None
    return 1e3 * busy_s(p) / p.queries
