"""Geometric mean of the latency of every query completed in the window,
in milliseconds: TPC-H's Power metric in form, each query type weighing
the same."""

import math


def read(trace):
    ms = [1e3 * c.latency_s for c in trace.calls if c.error is None]
    return math.exp(sum(map(math.log, ms)) / len(ms)) if ms else None
