"""Mean host reads of device values per query (the port's ``dftpu.sync``
spans, one per ``HOST_SYNCS`` increment): the front end, the collect and
the decode."""

from ..program import mean_per_query


def read(trace):
    return mean_per_query(trace, lambda p: p["span_n"].get("dftpu.sync", 0))
