"""Mean milliseconds per query the host waits on device reads inside the
port's ``dftpu.collect`` (its ``dftpu.sync`` spans: the overflow flag's
read, lazy row counts, copies to the host)."""

from ..program import mean_per_query


def read(trace):
    return mean_per_query(trace, lambda p: 1e3 * p["sync_s"].get("dftpu.collect", 0.0))
