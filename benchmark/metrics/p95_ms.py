"""95th percentile of the latency of every query completed in the window,
in milliseconds (``statistics.quantiles``, inclusive)."""

import statistics


def read(trace):
    ms = [1e3 * c.latency_s for c in trace.calls if c.error is None]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
