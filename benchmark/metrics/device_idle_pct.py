"""Share of the profiled pass's wall time in which nothing ran on the
card: the complement of the union of kernel, copy and fill intervals."""

from ..trace import busy_s


def read(trace):
    p = trace.profile
    if p is None or p.wall_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - busy_s(p) / p.wall_s)
