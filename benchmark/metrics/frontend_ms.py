"""Mean host milliseconds per query inside ``ctx.sql(text)``: the SQL
front end (``sql/``, ``logical/``, ``optimizer/`` of the port)."""


def read(trace):
    calls = trace.span_calls()
    return 1e3 * sum(c.frontend_s for c in calls) / len(calls) if calls else None
