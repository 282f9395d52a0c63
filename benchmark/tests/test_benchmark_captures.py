"""The reader ``captures_per_query`` on synthetic records of the port's
tracer: the mean of ``dftpu.graph.captures`` per query outside the
profiled pass, and nothing in a run whose queries carry no records."""

from benchmark import program
from benchmark.metrics import captures_per_query
from benchmark.trace import Call, Trace
from datafusion_tpu_torch import tracing


def _call(pass_no: int, captures: int) -> Call:
    c = Call("q", pass_no, latency_s=0.01, rows=1)
    counters = {(3, "dftpu.collect.whole"): 1}
    if captures:
        counters[(3, "dftpu.graph.captures")] = captures
        counters[(3, "dftpu.graph.pool_bytes")] = 1 << 20
    c.program = program.summarize(tracing.Records([], counters))
    return c


def test_mean_captures_outside_the_profiled_pass():
    calls = [_call(0, 0), _call(0, 1), _call(1, 5), _call(2, 0)]
    assert captures_per_query.read(Trace(calls, 1.0, 1.0, None, 1)) == 1 / 3


def test_no_capture_reads_zero_and_no_records_read_nothing():
    assert captures_per_query.read(Trace([_call(0, 0), _call(2, 0)], 1.0, 1.0, None, 1)) == 0
    bare = [Call("q", 0, latency_s=0.01, rows=1)]
    assert captures_per_query.read(Trace(bare, 1.0, 1.0, None, None)) is None
