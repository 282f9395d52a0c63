"""Host-resident tables streamed in morsels (datafusion_tpu_torch/
datasource/host.py, physical/morsel.py) against the JAX package.

Both engines get the same host table with morsel_rows=1024 (5 morsels of
tests/test_morsel.py's 5,000 rows): its six single-table queries and its
six join queries give the same rows in both, integers and decimals
exactly, floats within rel 1e-12.  The port host-resident also equals the
port device-resident, the plan streams, a Q1-shaped query calls K1 (its
plain version on the CPU) once per morsel, and a table of one short morsel
works; fault F15 is pinned.  TPC-H with a host-resident lineitem and
fault F14: test_torch_morsel_tpch.py.  The twins of tests/test_morsel.py
live in test_torch_morsel_twins.py."""

import math

import numpy as np
import pytest

import datafusion_tpu as J
from datafusion_tpu.columnar.table import Table as JTable
from bench.q1data import generate_lineitem_q1 as jax_lineitem
import datafusion_tpu_torch as D
from datafusion_tpu_torch import tracing
from datafusion_tpu_torch.datasource.host import HostTable
from datafusion_tpu_torch.ops import smalldomain as SD
from datafusion_tpu_torch.physical.morsel import MorselJoinStageExec, MorselStageExec
from datafusion_tpu_torch.q1data import generate_lineitem_q1
from datafusion_tpu_torch.queries import get_query_sql

from test_morsel import JOIN_QUERIES, QUERIES, _data
from torch_parity import port_table

REL = 1e-12
MORSEL = 1024


def assert_same_rows(pt, want: dict, label=""):
    """The port's result Table ``pt`` against rows ``want``: float columns
    within rel 1e-12 of max(|want|, 1), every other column exactly."""
    got = pt.to_pydict()
    assert list(got) == list(want), label
    for name, c in zip(pt.names, pt.columns):
        g, w = got[name], want[name]
        assert len(g) == len(w), (label, name, len(g), len(w))
        for x, y in zip(g, w):
            if c.dtype.is_float and x is not None and y is not None:
                assert (math.isnan(x) and math.isnan(y)) or abs(x - y) <= REL * max(abs(y), 1.0), (
                    label, name, x, y)
            else:
                assert x == y, (label, name, x, y)


def _contexts(tables: dict, host: set):
    """(JAX context, port context, port device-resident context) over the
    same tables; the names in ``host`` registered host-resident."""
    jctx = J.ExecutionContext()
    pctx = D.ExecutionContext(device="cpu")
    dctx = D.ExecutionContext(device="cpu")
    for name, jt in tables.items():
        pt = port_table(jt)
        dctx.register_table(name, pt)
        if name in host:
            jctx.register_host_table(name, jt, morsel_rows=MORSEL)
            pctx.register_host_table(name, pt, morsel_rows=MORSEL)
        else:
            jctx.register_table(name, jt)
            pctx.register_table(name, pt)
    return jctx, pctx, dctx


@pytest.fixture(scope="module")
def single():
    return _contexts({"t": JTable.from_pydict(_data())}, {"t"})


@pytest.fixture(scope="module")
def joins():
    rng = np.random.default_rng(1)
    n = 5000
    li = {
        "okey": rng.integers(0, 900, n).astype(np.int64),
        "qty": rng.integers(1, 50, n).astype(np.int64),
        "price": np.round(rng.uniform(1, 100, n), 2),
        "flag": np.array(["A", "B", "C"], dtype=object)[rng.integers(0, 3, n)],
    }
    orders = {
        "okey2": np.arange(900, dtype=np.int64),
        "cust": rng.integers(0, 40, 900).astype(np.int64),
        "status": np.array(["O", "F"], dtype=object)[rng.integers(0, 2, 900)],
    }
    return _contexts({"li": JTable.from_pydict(li), "o": JTable.from_pydict(orders)}, {"li"})


@pytest.mark.parametrize("q", QUERIES)
def test_morsel_matches_jax(single, q):
    jctx, pctx, dctx = single
    want = jctx.sql(q).collect().to_pydict()
    for _ in range(2):  # cold, then warm (learned capacities)
        assert_same_rows(pctx.sql(q).collect(), want, q)
    assert_same_rows(pctx.sql(q).collect(), dctx.sql(q).collect().to_pydict(), q)


@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_morsel_join_matches_jax(joins, q):
    jctx, pctx, dctx = joins
    want = jctx.sql(q).collect().to_pydict()
    for _ in range(2):
        assert_same_rows(pctx.sql(q).collect(), want, q)
    assert_same_rows(pctx.sql(q).collect(), dctx.sql(q).collect().to_pydict(), q)


def _physical(ctx, q):
    return ctx.create_physical_plan(ctx.optimize(ctx.sql(q).logical_plan()))


def _find(plan, cls):
    return isinstance(plan, cls) or any(_find(c, cls) for c in plan.children())


def test_morsel_plans_engage(single, joins):
    """The plans stream: a MorselStageExec over the host table, and a
    MorselJoinStageExec for each join the JAX package streams too."""
    _, pctx, _ = single
    for q in QUERIES:
        assert _find(_physical(pctx, q), MorselStageExec), q
    import datafusion_tpu.physical.morsel as jmorsel

    jctx, pctx, _ = joins
    for q in JOIN_QUERIES:
        ref = _find(_physical(jctx, q), jmorsel.MorselJoinStageExec)
        assert _find(_physical(pctx, q), MorselJoinStageExec) == ref, q


def test_q1_calls_k1_once_per_morsel(monkeypatch):
    """TPC-H Q1 over a host table of 60,012 rows in morsels of 8,192:
    the partial aggregate of every morsel takes the small-domain path, one
    K1 call each; the rows equal the JAX package's, host-resident too."""
    sf, m = 0.01, 8192
    host = HostTable.from_table(generate_lineitem_q1(sf, device="cpu"), m)
    assert host.num_morsels == 8 and host.nrows % m
    calls = []
    plain = SD.smalldomain_sum_count_plain

    def spy(gid, cols, masks, domain):
        calls.append(gid.shape[0])
        return plain(gid, cols, masks, domain)

    monkeypatch.setattr(SD, "smalldomain_sum_count_plain", spy)
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_host_table("lineitem", host)
    q1 = get_query_sql(1)
    got = [ctx.sql(q1).collect() for _ in range(2)]
    assert calls == [m] * (2 * host.num_morsels)
    jctx = J.ExecutionContext()
    jctx.register_host_table("lineitem", jax_lineitem(sf), morsel_rows=m)
    want = jctx.sql(q1).collect().to_pydict()
    for t in got:
        assert_same_rows(t, want, "q1")


def test_single_morsel_degenerate():
    """A host table smaller than one morsel: one short morsel, its tail
    zeroed, in both engines."""
    data = _data(100)
    jctx = J.ExecutionContext()
    jctx.register_host_table("t", JTable.from_pydict(data), morsel_rows=4096)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_host_table("t", D.Table.from_pydict(data, device="cpu"), morsel_rows=4096)
    host = pctx._resolve_table("t").host
    assert host.num_morsels == 1
    m = host.morsel(0)
    assert m.capacity == 4096 and m.nrows == 100
    assert not m.columns[0].valid[100:].any() and not m.columns[0].data[100:].any()
    for q in ("SELECT count(*) FROM t", QUERIES[0], QUERIES[2]):
        assert_same_rows(pctx.sql(q).collect(), jctx.sql(q).collect().to_pydict(), q)


def test_host_table_without_card_raises():
    """No device fallback: a host table for the card (device=None) raises
    where there is none, as every entry point does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(D.DataFusionError):
        HostTable.from_pydict({"a": [1, 2]})


def test_string_min_max_through_morsels_f15():
    """Fault F15: a partial min/max state over strings keeps the argument's
    dictionary in the port, so the merged result decodes; the JAX package's
    state carries none and returns NULLs.  Rows against numpy."""
    rng = np.random.default_rng(8)
    n = 5000
    s = np.array(["kiwi", "apple", "fig", "banana", "cherry"], dtype=object)[rng.integers(0, 5, n)]
    g = rng.integers(0, 4, n)
    data = {"g": g.astype(np.int64), "s": s}
    sql = "SELECT g, min(s) mn, max(s) mx FROM t GROUP BY g ORDER BY g"
    want = {"g": [0, 1, 2, 3], "mn": [min(s[g == i]) for i in range(4)], "mx": [max(s[g == i]) for i in range(4)]}
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_host_table("t", D.Table.from_pydict(data, device="cpu"), morsel_rows=1024)
    for _ in range(2):
        assert pctx.sql(sql).collect().to_pydict() == want
    jctx = J.ExecutionContext()
    jctx.register_host_table("t", JTable.from_pydict(data), morsel_rows=1024)
    got = jctx.sql(sql).collect().to_pydict()
    assert got["g"] == want["g"] and got["mn"] == got["mx"] == [None] * 4


def test_morsel_plans_are_dead_for_capture_and_int_keys_take_the_sort_path(single, monkeypatch):
    """A morsel plan is never checked nor captured (it is dead from its
    first collect, no failed attempt), and on the CPU its morsel loop
    captures no graph of a morsel either: every morsel runs node by node
    (``dftpu.morsel.eager``), none by a replay.  An integer GROUP BY key
    over morsels takes the sort path, as in the JAX package, whose morsel
    stages probe no key ranges; device-resident, the probe sends it to K1."""
    _, pctx, dctx = single
    calls = []
    plain = SD.smalldomain_sum_count_plain
    monkeypatch.setattr(SD, "smalldomain_sum_count_plain", lambda *a: (calls.append(1), plain(*a))[1])
    q = "SELECT k, sum(q) s FROM t GROUP BY k ORDER BY k"
    tracing.drain()
    tracing.enable()
    try:
        for _ in range(3):
            got = pctx.sql(q).collect().to_pydict()
    finally:
        tracing.disable()
    counts = {}
    for (_, name), n in tracing.drain().counters.items():
        counts[name] = counts.get(name, 0) + n
    phys = pctx._plan_cache[list(pctx._plan_cache)[-1]]
    wq = phys._whole_query
    assert wq._dead and wq.failure is None and not wq.checked
    stage = next(n for n in _nodes(phys) if isinstance(n, MorselStageExec))
    assert stage.streamed and stage.capture_failures == 0
    assert counts.get("dftpu.morsel.replayed", 0) == 0
    assert counts["dftpu.morsel.eager"] == 3 * stage.host.num_morsels == 15
    assert calls == []
    assert dctx.sql(q).collect().to_pydict() == got and len(calls) == 1


def _nodes(plan):
    yield plan
    for c in plan.children():
        yield from _nodes(c)
