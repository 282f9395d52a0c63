"""Mean milliseconds per query in the port's ``dftpu.decode.convert``
spans: each result column's host arrays turned into Python values
(``Column.numpy_to_pylist`` inside ``Table.to_pydict``)."""

from ..program import mean_per_query, span_ms


def read(trace):
    return mean_per_query(trace, span_ms("dftpu.decode.convert"))
