"""Mean megabytes (10^6 bytes) per query that the port copies from host
memory to the device (``dftpu.h2d.bytes``: host tables' morsels and
materializations, ``datasource/host.py``).  Nothing in a run that copies
none."""

from ..program import counter, mean_per_query


def read(trace):
    mb = mean_per_query(trace, counter("dftpu.h2d.bytes"))
    return mb / 1e6 if mb else None
