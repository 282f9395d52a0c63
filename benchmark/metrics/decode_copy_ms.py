"""Mean milliseconds per query in the port's ``dftpu.decode.copy`` spans:
each result column copied from the device into host memory
(``Column.to_numpy`` inside ``Table.to_pydict``)."""

from ..program import mean_per_query, span_ms


def read(trace):
    return mean_per_query(trace, span_ms("dftpu.decode.copy"))
