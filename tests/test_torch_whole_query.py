"""Whole-query execution in the torch port (physical/query_compiler.py)
against the JAX package's whole-query programs, on the CPU.

Twins of tests/test_whole_query.py and of
tests/test_capacity_edges.py::test_speculation_overflow_falls_back_exact:
each runs in both engines on the same seeded numpy data (the port gets the
JAX package's buffers unchanged, ``torch_parity.port_table``) and the rows
are compared exactly.  Where the JAX package compiles a warm plan into one
program (``_whole_query._fn`` set), the port becomes one unit after the
same number of collects (``WholeQuery.is_program``: on the CPU, which has
no CUDA graphs, the checked speculative path).  Also: the host-read guard,
the host reads a warm run makes, and engagement parity on TPC-H queries at
SF 0.01.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

import datafusion_tpu as J
from datafusion_tpu.columnar import Table as JTable
from datafusion_tpu.ops import kernels as JK

import datafusion_tpu_torch as D
from datafusion_tpu_torch.columnar.table import BUILD, HOST_SYNCS, Table, host_numpy, host_values
from datafusion_tpu_torch.errors import HostReadInWholeQuery
from datafusion_tpu_torch.ops import kernels as PK
from datafusion_tpu_torch.queries import run_tpch

from torch_parity import port_table


def _tables(n=5000, keys=200) -> dict:
    rng = np.random.default_rng(7)
    return {
        "f": {"k": rng.integers(0, keys, n), "x": rng.integers(0, 1000, n)},
        "d": {"k": np.arange(keys), "y": rng.integers(0, 50, keys)},
        "e": {"y2": np.arange(50), "z": rng.integers(0, 8, 50)},
    }


def _register(jctx, pctx, name, data):
    jt = JTable.from_pydict(data)
    jctx.register_table(name, jt)
    pctx.register_table(name, port_table(jt))


def _both(tables: dict):
    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    for name, data in tables.items():
        _register(jctx, pctx, name, data)
    return jctx, pctx


def _wq(ctx):
    return getattr(ctx._plan_cache[list(ctx._plan_cache)[-1]], "_whole_query", None)


def _jax_program(jctx) -> bool:
    wq = _wq(jctx)
    return wq is not None and wq._fn is not None


def _port_program(pctx) -> bool:
    wq = _wq(pctx)
    return wq is not None and wq.is_program


def _runs(jctx, pctx, sql, n=4):
    """n collects of sql in each engine: the rows of each (equal across
    the engines and the runs), and whether each became one unit."""
    rows = []
    for _ in range(n):
        want = jctx.sql(sql).collect().to_pydict()
        got = pctx.sql(sql).collect().to_pydict()
        assert got == want
        rows.append(got)
    assert all(r == rows[0] for r in rows)
    return rows[0], _jax_program(jctx), _port_program(pctx)


def test_multi_join_aggregate_fuses_and_matches():
    jctx, pctx = _both(_tables())
    sql = (
        "SELECT z, count(*) AS c, sum(x) AS sx FROM f "
        "JOIN d ON f.k = d.k JOIN e ON d.y = e.y2 GROUP BY z ORDER BY z"
    )
    _, jax_prog, port_prog = _runs(jctx, pctx, sql)
    assert jax_prog and port_prog


def test_filters_projections_sorts_fuse():
    jctx, pctx = _both(_tables())
    sql = (
        "SELECT f.k, x + 1 AS x1, y FROM f JOIN d ON f.k = d.k "
        "WHERE x > 100 AND y < 40 ORDER BY x1 DESC LIMIT 17"
    )
    _, jax_prog, port_prog = _runs(jctx, pctx, sql)
    assert jax_prog and port_prog


def test_overflow_invalidates_and_reruns_exactly():
    # the learned capacities of the first data overflow on the second
    # (same shapes, every row passing the filter): the window reruns
    # exactly, relearns, and the plan becomes one unit again
    jctx, pctx = _both(_tables())
    sql = "SELECT count(*) AS c, sum(x) AS sx FROM f JOIN d ON f.k = d.k WHERE y < 25"
    _, jax_prog, port_prog = _runs(jctx, pctx, sql, n=3)
    assert jax_prog and port_prog
    _register(jctx, pctx, "d", {"k": np.arange(200), "y": np.zeros(200, dtype=np.int64)})
    got, jax_prog, port_prog = _runs(jctx, pctx, sql, n=3)
    assert got["c"] == [5000]
    assert jax_prog and port_prog


def test_overflow_after_the_program_reruns_exactly():
    """The data under one cached plan outgrows what the plan learned (the
    build side's keys are rewritten in place, so the plan, its learned
    capacities and its program stay): the flag reruns the query exactly,
    the program is dropped, and two collects later the plan is one unit
    again with the relearned capacities."""
    tables = _tables()
    _, pctx = _both(tables)
    # an outer join is not speculated before it has learned its capacities
    sql = "SELECT count(*) AS c, sum(y) AS sy FROM f LEFT JOIN d ON f.k = d.k"
    for _ in range(3):
        pctx.sql(sql).collect()
    wq = _wq(pctx)
    assert wq.is_program
    pctx.table("d").collect().column("k").data.zero_()
    n0 = int((tables["f"]["k"] == 0).sum())  # each now meets all 200 rows of d
    want = {"c": [5000 - n0 + 200 * n0], "sy": [n0 * int(tables["d"]["y"].sum())]}
    syncs = HOST_SYNCS[0]
    assert pctx.sql(sql).collect().to_pydict() == want
    assert not wq.is_program  # dropped: this collect reran exactly
    assert HOST_SYNCS[0] - syncs > 1  # the flags, then the exact run's reads
    for _ in range(2):
        assert pctx.sql(sql).collect().to_pydict() == want
    assert wq.is_program and wq.failure is None


def test_kill_switch(monkeypatch):
    monkeypatch.setenv("DFTPU_NO_WHOLE_QUERY", "1")
    jctx, pctx = _both(_tables())
    sql = "SELECT count(*) AS c FROM f JOIN d ON f.k = d.k"
    _, jax_prog, port_prog = _runs(jctx, pctx, sql)
    assert not jax_prog and not port_prog


def test_semi_join_subquery_matches():
    jctx, pctx = _both(_tables())
    sql = "SELECT count(*) AS c FROM f WHERE f.k IN (SELECT k FROM d WHERE y > 25)"
    _, jax_prog, port_prog = _runs(jctx, pctx, sql)
    assert jax_prog == port_prog


def test_speculation_overflow_falls_back_exact(monkeypatch):
    """A fan-out join whose candidate total exceeds the probe capacity
    overflows the speculation window and reruns exactly: the rows of the
    run without speculation, in both engines."""
    n = 5000  # capacity 8192; a fan-out of 4 makes 20,000 pairs
    tables = {
        "t": {"k": np.arange(n) % 100, "pv": np.arange(n)},
        "u": {"k2": np.repeat(np.arange(100), 4), "bv": np.arange(400)},
    }
    sql = "SELECT count(*) c, sum(pv) s, sum(bv) b FROM t JOIN u ON k = k2"
    jctx, pctx = _both(tables)
    want = jctx.sql(sql).collect().to_pydict()
    got = pctx.sql(sql).collect().to_pydict()
    assert got == want and got["c"] == [n * 4]
    # the kill switch is read when a thread's state starts: turn this
    # thread's off by hand, as the reference's test does
    monkeypatch.setenv("DATAFUSION_TPU_NO_SPECULATIVE_JOINS", "1")
    JK.SPECULATION.enabled = PK.SPECULATION.enabled = False
    try:
        jctx, pctx = _both(tables)
        assert jctx.sql(sql).collect().to_pydict() == want
        assert pctx.sql(sql).collect().to_pydict() == want
    finally:
        JK.SPECULATION.enabled = PK.SPECULATION.enabled = True


def test_host_read_guard_raises_inside_a_build_only():
    t = Table.from_pydict({"a": [1, 2, 3]}, device="cpu")
    count = torch.tensor(3)
    assert Table(t.names, t.columns, count).nrows == 3
    assert host_values(count) == 3 and host_numpy(count) == 3
    BUILD.active = True
    try:
        with pytest.raises(HostReadInWholeQuery, match="row count"):
            Table(t.names, t.columns, count).nrows
        with pytest.raises(HostReadInWholeQuery, match="device value"):
            host_values(count)
        with pytest.raises(HostReadInWholeQuery, match="device tensor"):
            host_numpy(count)
        assert Table(t.names, t.columns, 3).nrows == 3  # a count the host holds
    finally:
        BUILD.active = False
    assert Table(t.names, t.columns, count).nrows == 3


def test_a_node_that_reads_the_host_keeps_the_plan_node_by_node():
    """A cross join of two many-row inputs reads both counts on the host:
    neither engine makes the plan one unit, and the guard names the node."""
    jctx, pctx = _both(_tables())
    sql = (
        "SELECT a.k, b.z FROM (SELECT k, y FROM d WHERE y > 10) a "
        "CROSS JOIN (SELECT z FROM e WHERE z > 2) b WHERE y + z > 40 ORDER BY a.k, b.z"
    )
    got, jax_prog, port_prog = _runs(jctx, pctx, sql)
    assert not jax_prog and not port_prog
    kind, message = _wq(pctx).failure
    assert kind == "guard" and message.startswith("CrossJoinExec") and "row count" in message


def test_two_collects_of_a_program_share_no_buffers():
    _, pctx = _both(_tables())
    sql = "SELECT f.k, x * y AS xy FROM f JOIN d ON f.k = d.k WHERE x > 500"
    outs = [pctx.sql(sql).collect() for _ in range(4)]
    assert _port_program(pctx)
    a, b = outs[-2], outs[-1]
    want = b.to_pydict()
    for ca, cb in zip(a.columns, b.columns):
        assert ca.data.data_ptr() != cb.data.data_ptr()
        assert ca.valid.data_ptr() != cb.valid.data_ptr()
        ca.data.zero_()
    assert b.to_pydict() == want


# ---- engagement parity on TPC-H at SF 0.01 ---------------------------------

# the flag-free plans: no speculative join, and a root stage that does not
# shrink, so their warm runs read nothing on the host
FLAG_FREE = {1, 6}


@pytest.fixture(scope="module")
def tpch_contexts():
    from torch_tpch import jax_tables

    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    for name, t in jax_tables().items():
        jctx.register_table(name, t)
        pctx.register_table(name, port_table(t))
    return jctx, pctx


# the plans that are one unit in the port and not in the JAX package, and
# why: Q16's CrossJoinAggExec reads its inputs' row counts and each tile's
# count on every run in the JAX package (ops/joinagg.py:93, :127), where
# the port learns them on its first run; Q22's CrossJoinExec (the one-row
# broadcast of the average balance) reads a count in the JAX package and
# none in the port.  Q21 (not run here: its JAX programs take the longest
# to compile) is one unit in both on these tables (seed 42); on the port's
# seed-7 tables the JAX package never makes it one, by reference fault F9
# (a join whose probe rows verify twice keeps overflowing)
PORT_ONLY = {16, 22}


@pytest.mark.parametrize("q", [1, 3, 4, 6, 12, 15, 16, 18, 22])
def test_tpch_whole_query_engagement_matches_jax(q, tpch_contexts):
    """After the same three collects the port is one unit exactly where
    the JAX package compiled one program (and also where ``PORT_ONLY``
    says why not), with its rows; the third collect reads the host once
    (the flags' sum) or, for a flag-free plan, never."""
    jctx, pctx = tpch_contexts
    for i in range(3):
        want = run_tpch(jctx, q).to_pydict()
        syncs = HOST_SYNCS[0]
        got_t = run_tpch(pctx, q)
        syncs = HOST_SYNCS[0] - syncs
        got = got_t.to_pydict()
        assert list(got) == list(want)
        for k in want:
            if any(isinstance(v, float) for v in want[k]):
                assert got[k] == pytest.approx(want[k], rel=1e-12), (q, k)
            else:
                assert got[k] == want[k], (q, k)
    assert _jax_program(jctx) == (q not in PORT_ONLY), q
    assert _port_program(pctx), (q, _wq(pctx).failure)
    assert syncs == (0 if q in FLAG_FREE else 1)


def test_speculative_expansion_fills_its_slots_and_reports_the_total():
    """The expansion at a capacity below the candidate total: the pairs of
    the first slots in the reference's order, the total for the flag, and
    every index inside its table (on the card an index past a table would
    fail a device-side assert)."""
    counts = torch.tensor([3, 0, 5, 4])
    lo = torch.tensor([0, 0, 3, 8])
    order = torch.arange(12)
    probe, build, alive, total = PK.join_expand(lo, counts, order, 8)
    assert int(total) == 12 and alive.tolist() == [True] * 8
    assert probe.tolist() == [0, 0, 0, 2, 2, 2, 2, 2]
    assert build.tolist() == [0, 1, 2, 3, 4, 5, 6, 7]
    probe, build, alive, total = PK.join_expand(lo, counts, order, 16)
    assert int(total) == 12 and alive.tolist() == [True] * 12 + [False] * 4
    assert probe[:12].tolist() == [0, 0, 0, 2, 2, 2, 2, 2, 3, 3, 3, 3]
    assert build[:12].tolist() == list(range(12))
    assert int(probe.max()) < 4 and int(build.max()) < 12


def test_a_new_catalog_version_drops_the_cached_plans():
    """Registering a table makes every cached plan unreachable (the cache
    keys on the catalog version): the context drops them and ends their
    whole-query state, which on the card frees their graphs."""
    _, pctx = _both(_tables())
    sql = "SELECT count(*) AS c FROM f JOIN d ON f.k = d.k"
    want = [pctx.sql(sql).collect().to_pydict() for _ in range(3)][0]
    wq = _wq(pctx)
    assert wq.is_program
    pctx.register_table("e", pctx.table("e").collect())
    assert not pctx._plan_cache
    assert not wq.is_program and wq.execute() is None
    assert pctx.sql(sql).collect().to_pydict() == want


def test_out_of_memory_releases_the_graphs_and_runs_again(monkeypatch):
    """An allocation that fails while graphs hold the card's memory: the
    context releases them and runs the query once more; with nothing to
    release the error goes up."""
    from datafusion_tpu_torch.execution import context as C
    from datafusion_tpu_torch.physical import query_compiler as QC

    _, pctx = _both(_tables())
    sql = "SELECT count(*) AS c, sum(x) AS sx FROM f JOIN d ON f.k = d.k"
    want = pctx.sql(sql).collect().to_pydict()
    real, failures, released = C._run, [1], []

    def run(phys):
        if failures:
            failures.pop()
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real(phys)

    monkeypatch.setattr(C, "_run", run)
    monkeypatch.setattr(QC, "release_graphs", lambda: released.append(1) or True)
    assert pctx.sql(sql).collect().to_pydict() == want
    assert released == [1]
    failures.append(1)
    monkeypatch.setattr(QC, "release_graphs", lambda: False)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        pctx.sql(sql).collect()


def test_a_dropped_context_frees_its_whole_query_state_at_once():
    """The plan and its whole-query state form no cycle: when the context
    goes, so does the state (on the card, its graph), without waiting for
    the garbage collector."""
    import gc
    import weakref

    _, pctx = _both(_tables())
    sql = "SELECT count(*) AS c FROM f JOIN d ON f.k = d.k"
    for _ in range(3):
        pctx.sql(sql).collect()
    ref = weakref.ref(_wq(pctx))
    gc.disable()
    try:
        del pctx
        assert ref() is None
    finally:
        gc.enable()
