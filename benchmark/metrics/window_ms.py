"""Mean milliseconds per query of the port's window operators inside its
``dftpu.collect``: the ``dftpu.window`` spans (sort, partition ids and
the window functions) plus the ``dftpu.rolling`` spans.  Host time: an
operator that runs eagerly queues its kernels inside the span, and a
CUDA graph's replay records no span, so a captured window reads 0."""

from ..program import mean_per_query


def read(trace):
    return mean_per_query(
        trace, lambda p: 1e3 * (p["span_s"].get("dftpu.window", 0.0) + p["span_s"].get("dftpu.rolling", 0.0)))
