"""The port's tracer (``datafusion_tpu_torch/tracing.py``) on the CPU: off
it records nothing and reads no clock; on, its spans nest under the right
parents and share the query's request id, its counters count what the
collect did (eager, whole, an exact rerun and the bytes copied to the
device), each CUDA-graph capture (faked here, where there is no card) and
the bytes it grew the graphs' pool by, and the result columns the decode
converted value by value, and it leaves every host sync as it was."""

import contextlib

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as D
from datafusion_tpu_torch import tracing
from datafusion_tpu_torch.columnar.convert import table_from_host
from datafusion_tpu_torch.columnar.table import HOST_SYNCS
from datafusion_tpu_torch.datasource.host import HostTable
from datafusion_tpu_torch.parallel.collectives import EXCHANGE_RANGE
from datafusion_tpu_torch.parallel.mesh import make_mesh
from datafusion_tpu_torch.physical import query_compiler as QC

GROUPED = "SELECT g, sum(v) AS s, count(*) AS c FROM t GROUP BY g ORDER BY g"
MORSEL = 1024


@pytest.fixture(autouse=True)
def tracer():
    """Every test starts and ends with the tracer off and its buffer empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _data(n=5000, seed=3) -> dict:
    rng = np.random.default_rng(seed)
    return {"g": rng.choice(["a", "b", "c", "d"], n).tolist(), "v": rng.integers(0, 1000, n),
            "k": rng.integers(0, 200, n)}


def _ctx(host: bool = False):
    ctx = D.ExecutionContext(device="cpu")
    t = D.Table.from_pydict(_data(), device="cpu")
    if host:
        ctx.register_host_table("t", t, morsel_rows=MORSEL)
    else:
        ctx.register_table("t", t)
    rng = np.random.default_rng(4)
    ctx.register_table("d", D.Table.from_pydict({"k": np.arange(200), "y": rng.integers(0, 50, 200)},
                                                device="cpu"))
    return ctx


def _query(ctx, sql=GROUPED) -> dict:
    return ctx.sql(sql).collect().to_pydict()


def _by_id(spans) -> dict:
    return {s.id: s for s in spans}


def _root(s, ids):
    while s.parent is not None:
        s = ids[s.parent]
    return s


def test_off_records_nothing():
    ctx = _ctx(host=True)
    _query(ctx)
    with tracing.span("dftpu.test"):
        tracing.count("dftpu.test", 5)
    rec = tracing.drain()
    assert rec.spans == [] and rec.counters == {}
    assert tracing.span("dftpu.a") is tracing.span("dftpu.b", request=1)  # one shared no-op


def test_off_reads_no_clock(monkeypatch):
    reads = []
    clock = tracing.time.perf_counter_ns

    def counted():
        reads.append(1)
        return clock()

    monkeypatch.setattr(tracing.time, "perf_counter_ns", counted)
    with tracing.span("dftpu.test"):
        tracing.count("dftpu.test")
    _query(_ctx(host=True))
    assert reads == []
    tracing.enable()
    with tracing.span("dftpu.test"):
        pass
    assert len(reads) == 2


def test_spans_nest_and_share_the_request():
    ctx = _ctx()
    _query(ctx)
    tracing.enable()
    df = ctx.sql(GROUPED)
    table = df.collect()
    rows = table.to_pydict()
    rec = tracing.drain()
    assert rows["g"] == ["a", "b", "c", "d"]
    ids = _by_id(rec.spans)
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["dftpu.sql", "dftpu.collect", "dftpu.decode"]
    request = roots[0].request
    assert request is not None and df._request == request and table.request == request
    assert {s.request for s in rec.spans} == {request}
    assert {k[0] for k in rec.counters} == {request}
    parent = {s.name: ids[s.parent].name for s in rec.spans if s.parent is not None and s.name != "dftpu.sync"}
    assert parent == {"dftpu.sql.parse": "dftpu.sql", "dftpu.sql.plan": "dftpu.sql",
                      "dftpu.collect.plan": "dftpu.collect", "dftpu.collect.run": "dftpu.collect",
                      "dftpu.decode.copy": "dftpu.decode", "dftpu.decode.convert": "dftpu.decode"}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = ids[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    # the decode's row count is read once, inside the decode
    syncs = [s for s in rec.spans if s.name == "dftpu.sync"]
    assert [ids[s.parent].name for s in syncs if _root(s, ids).name == "dftpu.decode"] == ["dftpu.decode"]
    # a second query gets a request of its own
    _query(ctx)
    (again,) = {s.request for s in tracing.drain().spans}
    assert again > request


def test_collects_count_eager_then_whole():
    ctx = _ctx()
    tracing.enable()
    modes = []
    for _ in range(4):
        _query(ctx)
        rec = tracing.drain()
        assert [s.name for s in rec.spans].count("dftpu.collect.run") == 1
        c = {name: n for (_, name), n in rec.counters.items()}
        assert "dftpu.collect.rerun" not in c
        (mode,) = [m for m in ("whole", "eager") if c.get(f"dftpu.collect.{m}")]
        assert c[f"dftpu.collect.{mode}"] == 1
        modes.append(mode)
    assert modes == ["eager", "whole", "whole", "whole"]


def test_forced_overflow_counts_a_rerun():
    """The build side's keys rewritten under a cached plan (as
    test_torch_whole_query's overflow test does): the speculated join
    overflows and the collect reruns exactly."""
    ctx = _ctx()
    sql = "SELECT count(*) AS c, sum(y) AS sy FROM t LEFT JOIN d ON t.k = d.k"
    for _ in range(3):
        _query(ctx, sql)
    ctx.table("d").collect().column("k").data.zero_()
    tracing.enable()
    got = _query(ctx, sql)
    rec = tracing.drain()
    c = {name: n for (_, name), n in rec.counters.items()}
    k = np.asarray(_data()["k"])
    n0 = int((k == 0).sum())
    assert got["c"] == [len(k) - n0 + 200 * n0]
    assert c["dftpu.collect.rerun"] == 1 and c["dftpu.collect.whole"] == 1
    ids = _by_id(rec.spans)
    # the overflow flag is read inside the collect's run
    assert any(s.name == "dftpu.sync" and ids[s.parent].name == "dftpu.collect.run" for s in rec.spans)


class _FakeGraphs:
    """The CUDA calls of ``query_compiler``'s capture and replay, faked on
    the CPU: the plans' state takes its device to be a card, a capture
    runs the plan once (as the real one records it) and grows the reserved
    memory by the next of ``GROWTH``, a replay does nothing, so its
    outputs are the capture's."""

    GROWTH = (3 << 20, 5 << 20, 7 << 20)

    def __init__(self, monkeypatch):
        self.reserved, self.captures = 0, 0
        fake = self

        class Graph:
            def capture_begin(self, **_):
                pass

            def capture_end(self):
                fake.reserved += fake.GROWTH[fake.captures % len(fake.GROWTH)]
                fake.captures += 1

            def replay(self):
                pass

        class Stream:
            def wait_stream(self, _):
                pass

        class Pool:
            id = (0, 1)

        cuda = torch.cuda
        for name, value in [("CUDAGraph", Graph), ("Stream", lambda *_: Stream()),
                            ("current_stream", lambda *_: Stream()), ("MemPool", Pool),
                            ("stream", lambda _: contextlib.nullcontext()),
                            ("device", lambda _: contextlib.nullcontext()),
                            ("synchronize", lambda *_: None), ("empty_cache", lambda: None),
                            ("set_sync_debug_mode", lambda _: None), ("get_sync_debug_mode", lambda: 0),
                            ("memory_reserved", lambda *_: fake.reserved)]:
            monkeypatch.setattr(cuda, name, value)
        monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, _: None)
        monkeypatch.setattr(QC, "_POOLS", {})
        monkeypatch.setattr(QC, "_STREAMS", {})
        init = QC.WholeQuery.__init__

        def on_a_card(wq, phys):
            init(wq, phys)
            if wq.device is not None:
                wq.device = torch.device("cuda", 0)

        monkeypatch.setattr(QC.WholeQuery, "__init__", on_a_card)


def _counts(rec) -> dict:
    return {name: n for (_, name), n in rec.counters.items()}


def test_capture_records_nothing_while_off(monkeypatch):
    fake = _FakeGraphs(monkeypatch)
    ctx = _ctx()
    want = _query(ctx)
    for _ in range(4):
        assert _query(ctx) == want
    assert fake.captures == 1
    rec = tracing.drain()
    assert rec.spans == [] and rec.counters == {}


def test_capture_spans_and_counts_each_graph_once(monkeypatch):
    """Two plans, five collects each: the third captures (one span inside
    the collect's run, one capture, the pool's growth in bytes), the
    replays after it capture nothing."""
    fake = _FakeGraphs(monkeypatch)
    ctx = _ctx()
    other = "SELECT k, sum(v) AS s FROM t WHERE v > 100 GROUP BY k ORDER BY k"
    tracing.enable()
    seen, pool = [], 0
    for sql in (GROUPED, other):
        want = None
        for i in range(5):
            rows = _query(ctx, sql)
            want = want or rows
            assert rows == want
            rec = tracing.drain()
            c = _counts(rec)
            spans = [s for s in rec.spans if s.name == "dftpu.collect.capture"]
            seen.append((len(spans), c.get("dftpu.graph.captures", 0), c.get("dftpu.collect.whole", 0)))
            if spans:
                ids = _by_id(rec.spans)
                assert [ids[s.parent].name for s in spans] == ["dftpu.collect.run"]
                assert {k[0] for k in rec.counters} == {spans[0].request}
                pool += c["dftpu.graph.pool_bytes"]
            else:
                assert "dftpu.graph.pool_bytes" not in c
    assert seen == [(0, 0, 0), (0, 0, 1), (1, 1, 1), (0, 0, 1), (0, 0, 1)] * 2
    growth = [wq.pool_growth for wq in (p._whole_query for p in ctx._plan_cache.values())]
    assert fake.captures == 2 and sorted(growth) == list(_FakeGraphs.GROWTH[:2])
    assert pool == sum(growth) == (3 << 20) + (5 << 20)


def test_h2d_bytes_are_the_host_tables_morsels():
    ctx = _ctx(host=True)
    host = ctx._resolve_table("t").host
    tracing.enable()
    _query(ctx, "SELECT sum(v) AS s FROM t WHERE v > 10")
    rec = tracing.drain()
    c = {name: n for (_, name), n in rec.counters.items()}
    # the query reads column v: its int64 data and its validity, every row once
    i = host.names.index("v")
    want = host.datas[i].nbytes + host.valids[i].nbytes
    assert want == host.nrows * (8 + 1)
    assert c["dftpu.h2d.bytes"] == want
    morsels = [s for s in rec.spans if s.name == "dftpu.morsel"]
    assert host.num_morsels == 5 and len(morsels) == 5
    ids = _by_id(rec.spans)
    assert {_root(s, ids).name for s in morsels} == {"dftpu.collect"}
    assert [s.name for s in rec.spans].count("dftpu.morsel.merge") == 1


def test_h2d_bytes_of_a_morsel_join():
    ctx = _ctx(host=True)
    host = ctx._resolve_table("t").host
    sql = "SELECT sum(y) AS sy FROM t JOIN d ON t.k = d.k"
    tracing.enable()
    _query(ctx, sql)
    rec = tracing.drain()
    c = {name: n for (_, name), n in rec.counters.items()}
    i = host.names.index("k")
    assert c["dftpu.h2d.bytes"] == host.datas[i].nbytes + host.valids[i].nbytes
    assert [s.name for s in rec.spans].count("dftpu.morsel") == host.num_morsels


@pytest.mark.parametrize("sql", ["SELECT sum(v) AS s FROM t WHERE v > 10",
                                 "SELECT sum(y) AS sy FROM t JOIN d ON t.k = d.k"])
def test_morsel_counters_only_while_on(sql):
    """A morsel loop counts each morsel as run node by node
    (``dftpu.morsel.eager``) or by a graph's replay (``.replayed``), only
    while the tracer is on; on the CPU every morsel runs node by node and
    no capture's span opens."""
    ctx = _ctx(host=True)
    host = ctx._resolve_table("t").host
    want = _query(ctx, sql)
    assert _query(ctx, sql) == want
    assert tracing.drain() == tracing.Records([], {})
    tracing.enable()
    assert _query(ctx, sql) == want
    rec = tracing.drain()
    c = _counts(rec)
    assert c["dftpu.morsel.eager"] == host.num_morsels == 5
    assert "dftpu.morsel.replayed" not in c
    assert "dftpu.morsel.capture" not in {s.name for s in rec.spans}


def test_decode_spans_once_per_column():
    ctx = _ctx()
    sql = "SELECT g, sum(v) AS s, count(*) AS c, avg(v) AS a FROM t GROUP BY g ORDER BY g"
    table = ctx.sql(sql).collect()
    tracing.enable()
    rows = table.to_pydict()
    rec = tracing.drain()
    names = [s.name for s in rec.spans]
    assert len(rows) == 4 and names.count("dftpu.decode.copy") == 4 and names.count("dftpu.decode.convert") == 4
    assert names.count("dftpu.decode") == 1
    # copy then convert, column by column, under the decode
    ids = _by_id(rec.spans)
    parts = [s for s in rec.spans if s.name.startswith("dftpu.decode.")]
    assert [s.name for s in parts] == ["dftpu.decode.copy", "dftpu.decode.convert"] * 4
    assert {ids[s.parent].name for s in parts} == {"dftpu.decode"}


@pytest.mark.parametrize("values, exact", [
    ([2**53 + 1, 5], 1),  # past 2**53: value by value, counted once
    ([2**53, -(2**53)], 0),  # within: float64 division
    ([5, None], 0),  # a null row's storage past 2**53 does not count
])
def test_decode_counts_columns_converted_value_by_value(values, exact):
    data = np.array([0 if v is None else v for v in values], np.int64)
    valid = np.array([v is not None for v in values])
    if not valid.all():
        data[~valid] = 2**62
    table = table_from_host(["d", "i"], ["decimal(18,2)", "int64"], [data, data], [valid, None],
                            [None, None], len(values), device="cpu")
    tracing.enable()
    rows = table.to_pydict()
    rec = tracing.drain()
    assert rows["d"] == [None if v is None else v / 100 for v in values]
    assert rec.counters.get((None, "dftpu.decode.exact"), 0) == exact
    assert {name for _, name in rec.counters} <= {"dftpu.decode.exact"}


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_tracing_leaves_host_syncs_unchanged(host):
    """The same collects and decodes, on fresh contexts, with the tracer
    off and on: each makes the same host reads; on, each of them is one
    ``dftpu.sync`` span."""

    def syncs(on: bool):
        ctx = _ctx(host)
        if on:
            tracing.enable()
        out = []
        for _ in range(3):
            s0 = HOST_SYNCS[0]
            table = ctx.sql(GROUPED).collect()
            s1 = HOST_SYNCS[0]
            table.to_pydict()
            out.append((s1 - s0, HOST_SYNCS[0] - s1))
        tracing.disable()
        return out, tracing.drain()

    off, _ = syncs(False)
    on, rec = syncs(True)
    assert on == off
    assert [s.name for s in rec.spans].count("dftpu.sync") == sum(a + b for a, b in on)


def test_the_buffer_drops_the_oldest_records():
    tracing.enable()
    for i in range(tracing.CAPACITY + 6):
        with tracing.span("dftpu.test", request=i):
            pass
    rec = tracing.drain()
    assert [s.request for s in rec.spans] == list(range(6, tracing.CAPACITY + 6))
    assert tracing.drain().spans == []


def test_exchange_range_only_while_tracing():
    """The mesh's exchanges open their profiler range (``spmd.exchange``,
    which chip_smoke.py reads) through the tracer: only while it is on."""
    ctx = _ctx()
    mesh = make_mesh(4, device="cpu")
    acts = [torch.profiler.ProfilerActivity.CPU]

    def keys(on: bool) -> set:
        if on:
            tracing.enable()
        with torch.profiler.profile(activities=acts) as prof:
            ctx.sql("SELECT k, sum(v) AS s FROM t GROUP BY k").collect(mesh=mesh)
        tracing.disable()
        return {e.key for e in prof.key_averages()}

    assert EXCHANGE_RANGE not in keys(False)
    seen = keys(True)
    assert EXCHANGE_RANGE in seen and "dftpu.collect" in seen
    assert any(s.name == EXCHANGE_RANGE for s in tracing.drain().spans)


def test_explain_analyze_has_no_host_timer():
    ctx = _ctx()
    rows = ctx.sql("EXPLAIN ANALYZE " + GROUPED).collect().to_pydict()
    text = "\n".join(map(str, rows["plan"]))
    assert "output_rows" in text and "executions" in text
    assert "elapsed_ns" not in text


def test_explain_analyze_reads_its_row_counts_in_sync_spans():
    """EXPLAIN ANALYZE's lazy output-row counts are host reads too: each
    is a ``dftpu.sync`` span, as many as ``HOST_SYNCS`` counts."""
    ctx = _ctx()
    tracing.enable()
    s0 = HOST_SYNCS[0]
    ctx.sql("EXPLAIN ANALYZE " + GROUPED).collect()
    n = HOST_SYNCS[0] - s0
    assert n > 0
    assert [s.name for s in tracing.drain().spans].count("dftpu.sync") == n
