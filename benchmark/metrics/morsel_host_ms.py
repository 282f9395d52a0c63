"""Mean host milliseconds per morsel (not per query) in the port's
``dftpu.morsel`` spans: one morsel's fused stage or join, and the copies
issued for the next (``physical/morsel.py``).  Nothing in a run without
morsels."""

from ..program import program_calls


def read(trace):
    calls = program_calls(trace)
    n = sum(c.program["span_n"].get("dftpu.morsel", 0) for c in calls)
    if not n:
        return None
    return 1e3 * sum(c.program["span_s"].get("dftpu.morsel", 0.0) for c in calls) / n
