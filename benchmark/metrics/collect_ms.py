"""Mean milliseconds per query from the call of ``.collect()`` to the end
of the synchronize that the traced run adds after it: planning,
execution and the device work (``execution/context.py::collect``,
``physical/``, ``ops/``)."""


def read(trace):
    calls = trace.span_calls()
    return 1e3 * sum(c.collect_s for c in calls) / len(calls) if calls else None
