"""The readers of the port's spans and counters (``program.py``,
``metrics/<name>.py``) on synthetic records, the idle stretches put down
to program spans, and a whole traced run on the CPU at SF 0.01 with the
port's tracer on (``traced.py``)."""

import importlib

import pytest
import torch

from benchmark import program, run, traced
from benchmark.trace import Call, Profile, Trace
from datafusion_tpu_torch import tracing

MS = 1_000_000  # ns
PROGRAM_METRICS = [name for name, _ in traced.METRICS]


def read(name, trace):
    return importlib.import_module(f"benchmark.metrics.{name}").read(trace)


def span(i, parent, name, start_ms, end_ms):
    return tracing.Span(i, parent, 7, name, int(start_ms * MS), int(end_ms * MS))


def records(morsels: int, whole: bool, rerun: bool = False, h2d: int = 0):
    """One query: sql 0-2 ms; collect 2-40 (plan 2-3, run 3-38 with a sync
    36-38 and ``morsels`` morsel spans of 5 ms each); decode 40-60 (a sync
    40-41, copy 41-45, convert 45-59)."""
    spans = [span(2, 1, "dftpu.sql.parse", 0, 1), span(1, None, "dftpu.sql", 0, 2),
             span(4, 3, "dftpu.collect.plan", 2, 3)]
    spans += [span(10 + i, 5, "dftpu.morsel", 3 + 5 * i, 8 + 5 * i) for i in range(morsels)]
    spans += [span(6, 5, "dftpu.sync", 36, 38), span(5, 3, "dftpu.collect.run", 3, 38),
              span(3, None, "dftpu.collect", 2, 40), span(8, 7, "dftpu.sync", 40, 41),
              span(9, 7, "dftpu.decode.copy", 41, 45), span(11, 7, "dftpu.decode.convert", 45, 59),
              span(7, None, "dftpu.decode", 40, 60)]
    counters = {(7, "dftpu.collect.whole" if whole else "dftpu.collect.eager"): 1}
    if rerun:
        counters[(7, "dftpu.collect.rerun")] = 1
    if h2d:
        counters[(7, "dftpu.h2d.bytes")] = h2d
    return tracing.Records(spans, counters)


def calls():
    """Pass 0: a whole run with 2 morsels and a whole run that reran; pass 1
    (the profiled one): an eager run; pass 2: an eager run with 4 morsels;
    and a failed query."""
    out = []
    for p, morsels, whole, rerun in ((0, 2, True, False), (0, 0, True, True), (1, 0, False, False),
                                     (2, 4, False, False)):
        c = Call("q", p, latency_s=0.06, rows=3)
        c.program = program.summarize(records(morsels, whole, rerun, h2d=3_000_000 * morsels))
        out.append(c)
    bad = Call("q", 2, latency_s=0.01, error="RuntimeError: boom")
    bad.program = program.summarize(records(9, True, h2d=1))
    out.append(bad)
    return out


def test_summarize():
    p = program.summarize(records(3, True, h2d=5))
    assert p["span_s"]["dftpu.morsel"] == pytest.approx(0.015) and p["span_n"]["dftpu.morsel"] == 3
    assert p["span_s"]["dftpu.collect.plan"] == pytest.approx(0.001)
    assert p["sync_s"] == {"dftpu.collect": pytest.approx(0.002), "dftpu.decode": pytest.approx(0.001)}
    assert p["span_n"]["dftpu.sync"] == 2
    assert p["counters"] == {"dftpu.collect.whole": 1, "dftpu.h2d.bytes": 5}


def test_readers_leave_out_the_profiled_pass_and_failures():
    t = Trace(calls(), 4.5, 30.0, profiled_pass=1)  # counted: the first two and the fourth
    assert read("plan_ms", t) == pytest.approx(1.0)
    assert read("graph_replay_pct", t) == pytest.approx(100 / 3)  # one whole run without a rerun
    assert read("sync_wait_ms", t) == pytest.approx(2.0)
    assert read("syncs_per_query", t) == pytest.approx(2.0)
    assert read("morsel_host_ms", t) == pytest.approx(5.0)  # per morsel: 30 ms over 6
    assert read("h2d_mb", t) == pytest.approx(18 / 3)
    assert read("decode_copy_ms", t) == pytest.approx(4.0)
    assert read("decode_convert_ms", t) == pytest.approx(14.0)


def test_readers_find_nothing_in_an_untraced_run():
    plain = [Call("q", p, latency_s=0.05, rows=3) for p in range(3)]
    for name in PROGRAM_METRICS:
        assert read(name, Trace(plain, 1.0, 1.0)) is None, name
        assert read(name, Trace([], 1.0, 1.0)) is None, name


def test_morsels_and_copies_only_where_there_are_some():
    c = Call("q", 0, latency_s=0.05, rows=3)
    c.program = program.summarize(records(0, True))
    t = Trace([c], 1.0, 1.0)
    assert read("morsel_host_ms", t) is None and read("h2d_mb", t) is None
    assert read("graph_replay_pct", t) == 100.0


def test_idle_stretches_go_to_the_innermost_span():
    # device busy 0-10, 30-40, 70-100; idle 10-30 (mid 20), 40-70 (mid 55)
    p = Profile(start=0, end=120 * MS, queries=1)
    p.device = [(0, 10 * MS, "k", "kernel"), (30 * MS, 40 * MS, "k", "kernel"),
                (70 * MS, 100 * MS, "k", "kernel")]
    spans = [(0, 60 * MS, "dftpu.collect"), (5 * MS, 25 * MS, "dftpu.collect.run"),
             (12 * MS, 15 * MS, "dftpu.sync"), (18 * MS, 22 * MS, "dftpu.sync"),
             (50 * MS, 51 * MS, "dftpu.morsel")]
    got = dict(program.idle_by_span(p, spans))
    # 10-30 at 20: inside the second sync; 40-70 at 55: only the collect
    # holds it; 100-120 at 110: no span
    assert got == {"dftpu.sync": pytest.approx(0.020), "dftpu.collect": pytest.approx(0.030),
                   "between": pytest.approx(0.020)}
    assert program.idle_by_span(p, spans, top=1) == [("dftpu.collect", pytest.approx(0.030))]


def test_span_cost_is_measured():
    off, on = traced.span_cost(20_000)
    assert 0 < off < on
    assert not tracing.enabled() and tracing.drain().spans == []


def test_traced_run_on_the_cpu(capsys):
    workload = "sf10_host.nine"
    out = traced.traced_cell(workload, 2**31 + 99, 0.5, torch.device("cpu"), sf=0.01)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    # the harness's own host-clock metrics, as they were (no device on the CPU)
    assert {x["name"] for x in run.metrics_for(run.manifest(), workload, True)
            if x["source"] == "host_clock"} <= set(m)
    assert "breakdown" in out
    assert set(PROGRAM_METRICS) <= set(m)
    assert 0 <= m["graph_replay_pct"]["value"] <= 100
    err = capsys.readouterr().err
    assert "[idle-by-span] " in err and "[tracer] " in err
    assert not tracing.enabled()
