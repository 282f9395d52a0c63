"""Share of collects that ran as one unit (a CUDA graph's replay on the
card; the port's ``dftpu.collect.whole`` counter) with no exact rerun
after an overflow (``dftpu.collect.rerun``)."""

from ..program import program_calls


def read(trace):
    runs = [c.program["counters"] for c in program_calls(trace)]
    runs = [r for r in runs if r.get("dftpu.collect.whole", 0) + r.get("dftpu.collect.eager", 0)]
    if not runs:
        return None
    return 100.0 * sum(bool(r.get("dftpu.collect.whole")) and not r.get("dftpu.collect.rerun")
                       for r in runs) / len(runs)
