"""Mean host milliseconds per query in the port's ``dftpu.collect.plan``
span: the plan cache's key (``plan.display()``) and lookup, and optimize
and physical planning on a miss (``execution/context.py::collect``)."""

from ..program import mean_per_query, span_ms


def read(trace):
    return mean_per_query(trace, span_ms("dftpu.collect.plan"))
