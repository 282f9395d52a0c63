"""Mean milliseconds per query inside ``to_pydict()`` once the device is
done: the result decode (``columnar/column.py``, ``Table.to_pydict``)."""


def read(trace):
    calls = trace.span_calls()
    return 1e3 * sum(c.decode_s for c in calls) / len(calls) if calls else None
