"""Mean CUDA-graph captures per query (the port's ``dftpu.graph.captures``
counter, one per capture, ``physical/query_compiler.py``).  The warm-up
captures every plan of the mix, so a capture in the window means a plan
or its graph was lost: a plan cache miss, an overflow's recapture, or
the graphs released for memory.  Expected 0.  A program without the
counter reads 0 as well."""

from ..program import counter, mean_per_query


def read(trace):
    return mean_per_query(trace, counter("dftpu.graph.captures"))
