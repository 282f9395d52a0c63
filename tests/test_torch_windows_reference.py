"""The window cell's plain reference (``benchmark/reference/w1.py`` ..
``w4.py``, ``r1.py``) against the port on the CPU at SF 0.01: the timed
forms the benchmark runs and the full forms, every row, through the
benchmark's comparison; a planted fault per query, each refused; the
float32 control failing the exact money of W2 and the means of W3; and
the tracer's window spans and counters, which read no device value.

The comparison carries no NULL, and at this scale R1 has days whose
7 days hold no row of a mode, and W3's full form has a NULL lag and lead
at each partition's edges: both sides' NULLs are given here as a value
no row can hold (-1.00; prices are positive), so a NULL where the other
side has a value, or a value where it has a NULL, differs."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import control, ingest, program, reference, run, tpchgen
from benchmark.compare import compare
from benchmark.metrics import window_ms
from benchmark.reference import Result
from benchmark.trace import Call, Trace
from datafusion_tpu_torch import tracing
from datafusion_tpu_torch.columnar.table import HOST_SYNCS, round_capacity
from datafusion_tpu_torch.queries import window_sql

CHECKOUT = Path(__file__).resolve().parents[1]
MIX = json.loads((CHECKOUT / "benchmark" / "mixes" / "windows.json").read_text())["queries"]
CONFIG = json.loads((CHECKOUT / "benchmark" / "configs" / "tpch_sf10_dev.json").read_text())
FLOAT_LIMIT = CONFIG["limits"]["float_rel_err"]
CPU = torch.device("cpu")
SF, SEED = 0.01, 2**31 + 2121
NAMES = {q: q.upper() for q in MIX}
NULL = -1.0  # no price, sum or quantity is negative


@pytest.fixture(scope="module")
def data():
    return tpchgen.generate(SF, SEED, CPU)


@pytest.fixture(scope="module")
def ctx(data):
    return ingest.context(data, CONFIG, CPU)


@pytest.fixture(scope="module")
def x(data):
    return reference.Inputs(data, CPU)


def _port(ctx, sql: str) -> dict:
    rows = ctx.sql(sql).collect().to_pydict()
    return {k: [NULL if v is None else v for v in col] for k, col in rows.items()}


def _full(x, query: str) -> Result:
    """The reference's full form, NULLs as ``NULL``, with no ORDER BY or LIMIT."""
    m = reference.module(query)
    cols, valids = m.full(x)
    values = []
    for (_, kind), v, ok in zip(m.COLUMNS, cols, valids):
        v = reference._host(v).copy()
        if ok is not None:
            v[~ok.numpy()] = round(NULL * 10 ** int(kind[8:])) if kind.startswith("decimal:") else NULL
        values.append(v)
    return Result(list(m.COLUMNS), values, [], None, True)


def _timed(x, query: str) -> Result:
    """The reference's timed form; R1's, its full form, with its NULL days
    as ``NULL``."""
    return _full(x, query) if query == "r1" else reference.run(query, x)


def test_the_mix_and_its_texts():
    """The mix is the five window queries, and each query file is the
    port's timed form of it."""
    assert MIX == ["w1", "w2", "w3", "w4", "r1"]
    for q in MIX:
        assert run.query_text(q).strip() == window_sql(NAMES[q], True)


@pytest.mark.parametrize("query", MIX)
def test_port_equals_reference(query, ctx, x):
    """The timed form as the benchmark runs it, and the full form, every
    row; the timed forms' ORDER BY keys are unique, so the reference hands
    over no row beyond the LIMIT."""
    want = _timed(x, query)
    assert want.limit in (None, 100) and len(want.values[0]) == (100 if want.limit else 17682)
    v = compare(_port(ctx, run.query_text(query)), want)
    assert v.ok, v.reason
    assert v.float_err <= FLOAT_LIMIT
    full = _full(x, query)
    v = compare(_port(ctx, window_sql(NAMES[query], False)), full)
    assert v.ok, v.reason
    assert v.float_err <= FLOAT_LIMIT


def test_nulls_are_compared(x):
    """At this scale both NULL kinds occur, so the full forms' NULLs are
    held to the reference's."""
    assert (_full(x, "r1").values[2] == -100).sum() > 0
    w3 = _full(x, "w3")
    assert (w3.values[6] == -100).sum() == len(set(w3.values[0].tolist()))


# a fault planted in a query's text: the text replaced, and by what
FAULTS = {
    "w1": (" AS rk,", " + 1 AS rk,"),  # rank off by one
    "w4": ("RANGE BETWEEN 90 PRECEDING", "ROWS BETWEEN 90 PRECEDING"),  # RANGE read as ROWS
    "r1": ("RANGE 6 PRECEDING", "RANGE 5 PRECEDING"),  # the frame a day short
}


def _restarted_late(rows: dict) -> dict:
    """W2's running sum restarting one row late: each partition's first
    row carries the previous partition's total too."""
    out = {k: list(v) for k, v in rows.items()}
    supp, cume = out["l_suppkey"], out["cume"]
    for i in range(1, len(supp)):
        if supp[i] != supp[i - 1]:
            cume[i] = round(cume[i] + rows["cume"][i - 1], 2)
    return out


def _lag_across(rows: dict) -> dict:
    """W3's lag read across a partition boundary: each partition's first
    row takes the previous partition's last price (the next price of the
    row before that one) instead of NULL."""
    out = {k: list(v) for k, v in rows.items()}
    part, prev, nxt = out["l_partkey"], out["prev_p"], out["next_p"]
    for i in range(2, len(part)):
        if part[i] != part[i - 1] and part[i - 2] == part[i - 1]:
            prev[i] = nxt[i - 2]
    return out


# a fault planted in the port's rows of the full form, where the timed
# form's 100 rows cannot show it: W2's lie in the first partition, and
# W3's filter drops the rows at partitions' edges
ROW_FAULTS = {"w2": _restarted_late, "w3": _lag_across}


@pytest.mark.parametrize("query", MIX)
def test_planted_fault_is_refused(query, ctx, x):
    if query in ROW_FAULTS:
        rows = ROW_FAULTS[query](_port(ctx, window_sql(NAMES[query], False)))
        v = compare(rows, _full(x, query))
    else:
        old, new = FAULTS[query]
        text = run.query_text(query)
        assert text.count(old) == 1
        v = compare(_port(ctx, text.replace(old, new)), _timed(x, query))
    assert not v.ok or v.float_err > FLOAT_LIMIT


def test_control_fails_exact_money_and_means(x, data):
    """The float32 reference in the port's place: W2's running sums are
    not exact decimals, W3's means miss by more than the float limit, and
    the run's own check refuses it."""
    ctrl = reference.Inputs(data, CPU, money="float32")
    w2 = compare(reference.run("w2", ctrl).answer(), reference.run("w2", x))
    assert not w2.ok and "cume" in w2.reason
    w3 = compare(reference.run("w3", ctrl).answer(), reference.run("w3", x))
    assert w3.float_err > FLOAT_LIMIT
    r = control.readings("sf10_dev.windows", SEED, CPU, sf=SF)
    assert r["wrong_results"] >= 2 and r["float_rel_err"] > FLOAT_LIMIT


def _records(ctx, sql: str):
    """One collect with the tracer on: (its records, host syncs)."""
    tracing.drain()
    tracing.enable()
    try:
        s0 = HOST_SYNCS[0]
        ctx.sql(sql).collect()
        syncs = HOST_SYNCS[0] - s0
    finally:
        tracing.disable()
    return tracing.drain(), syncs


def _spans(ctx, sql: str):
    """One collect with the tracer on: (spans by id, counters, syncs)."""
    rec, syncs = _records(ctx, sql)
    counters = {}
    for (_, name), n in rec.counters.items():
        counters[name] = counters.get(name, 0) + n
    return {s.id: s for s in rec.spans}, counters, syncs


def _ancestors(spans: dict, s) -> list:
    out = []
    while s.parent is not None:
        s = spans[s.parent]
        out.append(s.name)
    return out


@pytest.mark.parametrize("query", ["w3", "r1"])
def test_window_spans_inside_collect_read_no_device_value(query, ctx, data, monkeypatch):
    """An eager run (node by node, no whole-query unit): the window's span
    and its three children, or the rolling window's span, open inside
    ``dftpu.collect.run``; ``dftpu.window.rows`` is the capacity the
    window sorts; the tracer adds no host sync."""
    monkeypatch.setenv("DFTPU_NO_WHOLE_QUERY", "1")
    sql = run.query_text(query)
    ctx.sql(sql).collect()
    s0 = HOST_SYNCS[0]
    ctx.sql(sql).collect()
    off = HOST_SYNCS[0] - s0
    spans, counters, on = _spans(ctx, sql)
    assert on == off
    names = [s.name for s in spans.values()]
    if query == "r1":
        assert names.count("dftpu.rolling") == 1 and "dftpu.window" not in names
        roll = next(s for s in spans.values() if s.name == "dftpu.rolling")
        assert "dftpu.collect.run" in _ancestors(spans, roll)
        return
    window = [s for s in spans.values() if s.name == "dftpu.window"]
    assert len(window) == 1
    assert "dftpu.collect.run" in _ancestors(spans, window[0])
    children = [s.name for s in spans.values() if s.parent == window[0].id]
    assert children == ["dftpu.window.sort", "dftpu.window.partition", "dftpu.window.eval"]
    assert counters["dftpu.window.exprs"] == 5
    # W3 sorts the whole of lineitem's buffer: its capacity
    assert counters["dftpu.window.rows"] == round_capacity(data.nrows("lineitem"))


def test_window_ms_reads_the_window_spans(ctx, monkeypatch):
    """``window_ms`` is the mean of the ``dftpu.window`` and
    ``dftpu.rolling`` spans' milliseconds per query, inside the collect;
    a run whose calls carry no program records reads nothing."""
    monkeypatch.setenv("DFTPU_NO_WHOLE_QUERY", "1")
    calls, want = [], []
    for i, q in enumerate(["w3", "r1"]):
        rec, _ = _records(ctx, run.query_text(q))
        c = Call(q, i)
        c.program = program.summarize(rec)
        calls.append(c)
        want.append(sum((s.end_ns - s.start_ns) / 1e6 for s in rec.spans
                        if s.name in ("dftpu.window", "dftpu.rolling")))
        assert want[-1] > 0
    assert window_ms.read(Trace(calls, 1.0, 1.0)) == pytest.approx(sum(want) / 2)
    assert window_ms.read(Trace([Call("w3", 0)], 1.0, 1.0)) is None
