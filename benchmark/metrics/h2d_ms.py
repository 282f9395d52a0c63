"""Device milliseconds per query of host-to-device copies in the profiled
pass (the profiler's memcpy records): the host tables' morsels
(``datasource/host.py``, ``physical/morsel.py``).  Nothing when the pass
copied nothing to the device."""


def read(trace):
    p = trace.profile
    if p is None or not p.queries:
        return None
    ns = sum(e - s for s, e, name, kind in p.device if kind == "gpu_memcpy" and "HtoD" in name)
    return ns / 1e6 / p.queries if ns else None
