"""Joins in the torch port against the JAX package on the CPU, on identical
buffers: the hash bit for bit, every join type at the operator level on
NULL keys, empty sides and fan-out, residual filters, cross joins, and
joins through SQL (string keys from two dictionaries, two-column keys,
uint64 keys at and above 2^63, float keys with -0.0 and NaN); and twins
of the JAX package's join tests (``tests/test_operators.py``,
``test_join_fk.py``, ``test_capacity_edges.py``, ``test_semi_pushdown.py``,
``test_subquery_semantics.py``).

Tolerance: none.  Every row, in order, equals the JAX package's (NaN
equal to NaN, -0.0 told from 0.0): the port emits the reference's pairs
in the reference's order (probe order, then the build rows' sorted-hash
order).
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as J
import datafusion_tpu.ops.kernels as JK
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.exprs.physical import PhysBinary as JPhysBinary, PhysCol as JPhysCol
from datafusion_tpu.ops.basic import MemoryExec as JMemoryExec
from datafusion_tpu.ops.join import CrossJoinExec as JCrossJoinExec, HashJoinExec as JHashJoinExec
from datafusion_tpu.types.dtypes import BOOL as JBOOL, FLOAT64 as JFLOAT64, INT64 as JINT64
from datafusion_tpu.types.dtypes import STRING as JSTRING, DataType as JDataType
import datafusion_tpu_torch as D
import datafusion_tpu_torch.ops.kernels as PK
from datafusion_tpu_torch.exprs.physical import PhysBinary, PhysCol
from datafusion_tpu_torch.ops.basic import MemoryExec
from datafusion_tpu_torch.ops.join import CrossJoinExec, HashJoinExec, join_tables
from datafusion_tpu_torch.types.dtypes import BOOL, INT64

from torch_join_cases import EDGE_SIDES, JOIN_TYPES
from torch_parity import assert_rows_equal, port_table


# ---------------------------------------------------------------------------
# the hash, bit for bit
# ---------------------------------------------------------------------------

_I64 = np.iinfo(np.int64)
HASH_CASES = {
    "negative": ([np.array([-1, -2, -(2**40), 0, 7, -7], np.int64)], "int64"),
    "extremes": ([np.array([_I64.min, _I64.max, _I64.min + 1, _I64.max - 1, 0, 1], np.int64)], "int64"),
    "two-columns": (
        [np.array([1, 1, 2, 2, 3, -3], np.int64), np.array([5, 6, 5, 6, _I64.max, _I64.min], np.int64)],
        "int64",
    ),
    "three-columns": ([np.arange(6, dtype=np.int64) * k for k in (1, -3, 2**33)], "int64"),
    "int32": ([np.array([0, -1, 2**31 - 1, -(2**31), 12, 13], np.int32)], "int32"),
    "uint64": ([np.array([0, 2**63, 2**64 - 1, 2**63 - 1, 2**63 + 5, 9], np.uint64)], "uint64"),
    "float": ([np.array([0.0, -0.0, 1.5, -2.25, np.inf, 1e300])], "float64"),
    "bool": ([np.array([True, False, True, True, False, False])], "bool"),
}


@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("case", list(HASH_CASES))
def test_hash_columns_bit_for_bit(case, nulls):
    """hashable_key -> hash_columns -> hash_fold32 and the build sort give
    the reference's bits and order (its uint64 read as int64, its uint32
    less 2^31)."""
    cols, kind = HASH_CASES[case]
    dt = JDataType(kind)
    rng = np.random.default_rng(len(case))
    valids = [
        (rng.random(len(c)) < 0.6) if nulls else np.ones(len(c), bool) for c in cols
    ]
    jh = JK.hash_columns(
        [JK.hashable_key(jnp.asarray(c), dt) for c in cols], [jnp.asarray(v) for v in valids]
    )
    ph = PK.hash_columns(
        [PK.hashable_key(torch.from_numpy(c), dt) for c in cols], [torch.from_numpy(v) for v in valids]
    )
    assert (np.asarray(jh).view(np.int64) == ph.numpy()).all()
    jf = np.asarray(JK.hash_fold32(jh)).astype(np.int64)
    pf = PK.hash_fold32(ph)
    assert pf.dtype == torch.int32 and (jf - 2**31 == pf.numpy()).all()
    n_alive = len(cols[0]) - 2
    js, jo = JK.join_build_sort(JK.hash_fold32(jh), jnp.int64(n_alive))
    ps, po = PK.join_build_sort(pf, n_alive)
    assert (np.asarray(jo) == po.numpy()).all()
    assert (np.asarray(js).astype(np.int64) - 2**31 == ps.numpy()).all()


@pytest.mark.parametrize("n_alive", [0, 37, 60])
def test_probe_counts_as_the_reference(n_alive):
    """The port's two binary searches give the reference's (lo, counts),
    which it reads from build run lengths: duplicate hashes, dead build
    rows pinned to uint32 max, probe hashes equal to the pin, dead and
    NULL-key probe rows."""
    rng = np.random.default_rng(n_alive)
    build = rng.integers(0, 12, 60).astype(np.uint32)
    build[:3] = np.iinfo(np.uint32).max
    probe = rng.integers(0, 14, 80).astype(np.uint32)
    probe[:4] = np.iinfo(np.uint32).max
    ok = rng.random(80) < 0.8
    js, _ = JK.join_build_sort(jnp.asarray(build), jnp.int64(n_alive))
    jlo, jcounts = JK.join_probe_counts_binary(
        js, JK.build_run_lengths(js), jnp.asarray(probe), jnp.asarray(ok), jnp.int64(n_alive)
    )
    ps, _ = PK.join_build_sort(torch.from_numpy(build.astype(np.int64) - 2**31).to(torch.int32), n_alive)
    plo, pcounts = PK.join_probe_counts_binary(
        ps, torch.from_numpy(probe.astype(np.int64) - 2**31).to(torch.int32), torch.from_numpy(ok), n_alive
    )
    assert plo.tolist() == np.asarray(jlo).tolist()
    assert pcounts.tolist() == np.asarray(jcounts).tolist()


def test_candidate_stats_are_int64():
    counts = torch.full((3,), 2**31 - 1, dtype=torch.int64)
    assert PK.candidate_stats(counts).tolist() == [3 * (2**31 - 1), 2**31 - 1]


# ---------------------------------------------------------------------------
# operator level: every join type on edge tables
# ---------------------------------------------------------------------------


def _mem_pair(data):
    jt = JTable.from_pydict(data, {"rv": JSTRING} if "rv" in data else None)
    return JMemoryExec(jt, jt.schema()), MemoryExec(pt := port_table(jt), pt.schema()), jt


def _col_pair(t, name):
    i = t.names.index(name)
    dt = t.columns[i].dtype
    return JPhysCol(name, i, dt), PhysCol(name, i, D.types.dtypes.DataType(dt.kind)
                                           if not dt.is_decimal else dt)


@pytest.mark.parametrize("jt_", JOIN_TYPES)
@pytest.mark.parametrize("edge", list(EDGE_SIDES))
def test_join_types_on_edge_tables(edge, jt_):
    ldata, rdata = EDGE_SIDES[edge]
    jl, pl, lt = _mem_pair(ldata)
    jr, pr, rt = _mem_pair(rdata)
    (jlk, plk), (jrk, prk) = _col_pair(lt, "k"), _col_pair(rt, "k2")
    want = JHashJoinExec(jl, jr, [(jlk, jrk)], jt_).execute().to_pydict()
    got = HashJoinExec(pl, pr, [(plk, prk)], jt_).execute().to_pydict()
    assert_rows_equal(got, want)


def test_join_types():
    """Twin of test_operators.py::test_join_types."""
    jl, pl, lt = _mem_pair({"k": [1, 2, 3, None], "lv": ["a", "b", "c", "d"]})
    jr, pr, rt = _mem_pair({"k2": [2, 3, 3, 5], "rv": [20, 30, 31, 50]})
    (jlk, plk), (jrk, prk) = _col_pair(lt, "k"), _col_pair(rt, "k2")
    sizes = {"inner": 3, "left": 5, "right": 4, "full": 6, "semi": 2, "anti": 2}
    for jt_, n in sizes.items():
        want = JHashJoinExec(jl, jr, [(jlk, jrk)], jt_).execute().to_pydict()
        got = HashJoinExec(pl, pr, [(plk, prk)], jt_).execute().to_pydict()
        assert_rows_equal(got, want)
        assert len(got["k"]) == n, jt_


@pytest.mark.parametrize("jt_", JOIN_TYPES)
def test_join_residual_filter(jt_):
    """Twin of test_operators.py::test_join_residual_filter, every type."""
    jl, pl, lt = _mem_pair({"k": [1, 1, 2, 3], "lv": [10, 20, 30, 40]})
    jr, pr, rt = _mem_pair({"k2": [1, 1, 2, 3], "rv": [15, 25, 100, 1]})
    (jlk, plk), (jrk, prk) = _col_pair(lt, "k"), _col_pair(rt, "k2")
    jf = JPhysBinary(JPhysCol("lv", 1, JINT64), "<", JPhysCol("rv", 3, JINT64), JBOOL)
    pf = PhysBinary(PhysCol("lv", 1, INT64), "<", PhysCol("rv", 3, INT64), BOOL)
    want = JHashJoinExec(jl, jr, [(jlk, jrk)], jt_, jf).execute().to_pydict()
    got = HashJoinExec(pl, pr, [(plk, prk)], jt_, pf).execute().to_pydict()
    assert_rows_equal(got, want)
    if jt_ == "inner":
        assert sorted(zip(got["lv"], got["rv"])) == [(10, 15), (10, 25), (20, 25), (30, 100)]


def test_cross_join():
    jl, pl, _ = _mem_pair({"a": [1, 2]})
    jr, pr, _ = _mem_pair({"rv": ["x", "y", "z"]})
    want = JCrossJoinExec(jl, jr).execute().to_pydict()
    got = CrossJoinExec(pl, pr).execute().to_pydict()
    assert_rows_equal(got, want)
    assert len(got["a"]) == 6


def test_duplicate_heavy_join():
    n = 1000
    jl, pl, lt = _mem_pair({"k": [i % 3 for i in range(n)], "lv": list(range(n))})
    jr, pr, rt = _mem_pair({"k2": [0, 0, 1]})
    (jlk, plk), (jrk, prk) = _col_pair(lt, "k"), _col_pair(rt, "k2")
    want = JHashJoinExec(jl, jr, [(jlk, jrk)], "inner").execute().to_pydict()
    got = HashJoinExec(pl, pr, [(plk, prk)], "inner").execute().to_pydict()
    assert_rows_equal(got, want)
    assert len(got["k"]) == 334 * 2 + 333


def test_join_metrics_count_candidates():
    jl, pl, lt = _mem_pair({"k": [1, 1, 2, 3], "lv": [10, 20, 30, 40]})
    jr, pr, rt = _mem_pair({"k2": [1, 1, 2, 5], "rv": [15, 25, 100, 1]})
    _, plk = _col_pair(lt, "k")
    _, prk = _col_pair(rt, "k2")
    op = HashJoinExec(pl, pr, [(plk, prk)], "inner")
    op.execute()
    assert op.metrics.counter("join_candidates").value == 5


# ---------------------------------------------------------------------------
# SQL
# ---------------------------------------------------------------------------


def sql_both(tables: dict, sql: str, runs: int = 1):
    """(port rows, JAX rows) of one query on fresh contexts over the same
    tables ({name: JAX Table}); with runs > 1 every later run must equal
    the first in each engine."""
    jctx = J.ExecutionContext()
    pctx = D.ExecutionContext(device="cpu")
    for name, jt in tables.items():
        jctx.register_table(name, jt)
        pctx.register_table(name, port_table(jt))
    want = jctx.sql(sql).collect().to_pydict()
    got = pctx.sql(sql).collect().to_pydict()
    for _ in range(runs - 1):
        assert_rows_equal(jctx.sql(sql).collect().to_pydict(), want)
        assert_rows_equal(pctx.sql(sql).collect().to_pydict(), got)
    return got, want


def _t(data, dtypes=None):
    return JTable.from_pydict(data, dtypes)


def test_string_keys_from_two_dictionaries():
    a = _t({"s": ["apple", "kiwi", "fig", None, "kiwi", "plum"], "v": [1, 2, 3, 4, 5, 6]})
    b = _t({"s2": ["kiwi", "fig", "date", "kiwi", None], "w": [10, 20, 30, 40, 50]})
    for jt_ in ("JOIN", "LEFT JOIN", "RIGHT JOIN", "FULL JOIN"):
        got, want = sql_both({"a": a, "b": b}, f"SELECT v, s, w, s2 FROM a {jt_} b ON s = s2")
        assert_rows_equal(got, want)
    got, want = sql_both({"a": a, "b": b}, "SELECT v FROM a WHERE s IN (SELECT s2 FROM b)")
    assert_rows_equal(got, want)
    assert got["v"] == [2, 3, 5]


def test_two_column_keys():
    rng = np.random.default_rng(4)
    a = _t({"k1": rng.integers(0, 4, 300), "k2": list(rng.choice(["x", "y", "z"], 300)), "v": np.arange(300)})
    b = _t({"k1b": rng.integers(0, 4, 50), "k2b": list(rng.choice(["y", "z", "w"], 50)), "w": np.arange(50)})
    for jt_ in ("JOIN", "LEFT JOIN", "FULL JOIN"):
        got, want = sql_both({"a": a, "b": b}, f"SELECT v, w, k1, k2b FROM a {jt_} b ON k1 = k1b AND k2 = k2b")
        assert_rows_equal(got, want)
    got, want = sql_both(
        {"a": a, "b": b},
        "SELECT v FROM a WHERE EXISTS (SELECT 1 FROM b WHERE b.k1b = a.k1 AND b.k2b = a.k2)",
    )
    assert_rows_equal(got, want)


def test_uint64_keys_at_and_above_2_63():
    u = np.array([0, 5, 2**63, 2**63 + 5, 2**64 - 1, 2**63 - 1], np.uint64)
    a = _t({"u": u, "v": np.arange(6)})
    b = _t({"u2": np.concatenate([u[::2], u[1::2]])[::-1].copy(), "w": np.arange(6) * 10})
    got, want = sql_both({"a": a, "b": b}, "SELECT v, w, u FROM a JOIN b ON u = u2")
    assert_rows_equal(got, want)
    assert sorted(got["v"]) == list(range(6))


def test_float_keys_signed_zero_and_nan():
    """Fault F7 of the reference, kept: the join hashes float32 bits, so
    -0.0 never meets 0.0 (though ``=`` holds between them) and NaN meets
    nothing.  ``x = 2`` rows become NaN through 0/0 (ingest reads NaN as
    NULL)."""
    a = _t({"x": [0.0, 2.0, 1.5], "ta": ["zero", "nan", "one-half"]})
    b = _t({"y": [-0.0, 2.0, 1.5], "tb": ["minus-zero", "nan", "one-half"]})
    nan_x = "CASE WHEN x = 2.0 THEN (x - x) / (x - x) ELSE x END"
    nan_y = "CASE WHEN y = 2.0 THEN (y - y) / (y - y) ELSE y END"
    sql = (f"SELECT ta, tb FROM (SELECT ta, {nan_x} AS xx FROM a) p "
           f"JOIN (SELECT tb, {nan_y} AS yy FROM b) q ON xx = yy")
    got, want = sql_both({"a": a, "b": b}, sql)
    assert_rows_equal(got, want)
    assert got == {"ta": ["one-half"], "tb": ["one-half"]}
    # a cross join and a comparison filter (no equi-key to hash): there
    # -0.0 meets 0.0
    got, want = sql_both({"a": a, "b": b}, "SELECT ta, tb FROM a, b WHERE x <= y AND x >= y ORDER BY ta")
    assert_rows_equal(got, want)
    assert got == {"ta": ["nan", "one-half", "zero"], "tb": ["nan", "one-half", "minus-zero"]}


def test_scalar_subquery_cross_join_broadcast():
    a = _t({"x": np.arange(20), "g": [i % 3 for i in range(20)]})
    got, want = sql_both({"a": a}, "SELECT x FROM a WHERE x > (SELECT avg(x) FROM a) ORDER BY x")
    assert_rows_equal(got, want)
    got, want = sql_both({"a": a}, "SELECT g, count(*) c FROM a, (SELECT max(x) m FROM a) s "
                                   "WHERE x + 10 > m GROUP BY g ORDER BY g")
    assert_rows_equal(got, want)


# ---- twins of tests/test_join_fk.py ------------------------------------------

FK_ROWS = {"k": list(range(50)), "y": [i * 10 for i in range(50)]}
DUP_ROWS = {"k": [i % 50 for i in range(100)], "y": [i * 10 for i in range(100)]}
FACT = {"k": [i % 50 for i in range(600)], "x": list(range(600))}


@pytest.mark.parametrize("jt_", ["inner", "left", "semi", "anti"])
def test_fk_warm_join_matches_cold(jt_):
    if jt_ in ("semi", "anti"):
        sql = f"SELECT k, x FROM f WHERE k {'IN' if jt_ == 'semi' else 'NOT IN'} (SELECT k FROM d)"
    elif jt_ == "inner":
        sql = "SELECT f.k, x, y FROM f JOIN d ON f.k = d.k"
    else:
        sql = "SELECT f.k, x, y FROM f LEFT JOIN d ON f.k = d.k"
    got, want = sql_both({"f": _t(FACT), "d": _t(FK_ROWS)}, sql, runs=3)
    assert_rows_equal(got, want)


def test_fk_violation_duplicate_build_keys():
    sql = "SELECT f.k, x, y FROM f JOIN d ON f.k = d.k"
    got, want = sql_both({"f": _t(FACT), "d": _t(DUP_ROWS)}, sql, runs=2)
    assert_rows_equal(got, want)
    assert len(got["k"]) == 1200


def test_fanout_join_ordered():
    sql = "SELECT f.k, x, y FROM f JOIN d ON f.k = d.k ORDER BY x, y"
    got, want = sql_both({"f": _t(FACT), "d": _t(DUP_ROWS)}, sql, runs=3)
    assert_rows_equal(got, want)


# ---- twins of tests/test_capacity_edges.py ------------------------------------


def test_fanout_beyond_probe_capacity():
    n = 5000
    probe = _t({"k": np.arange(n) % 100, "pv": np.arange(n)})
    build = _t({"k2": np.repeat(np.arange(100), 4), "bv": np.arange(400)})
    got, want = sql_both({"t": probe, "u": build}, "SELECT count(*) c, sum(pv) s, sum(bv) b FROM t JOIN u ON k = k2")
    assert_rows_equal(got, want)
    assert got["c"] == [n * 4]


def test_join_shrink_right_sizes_tiny_survivors():
    n = 200_000
    rng = np.random.default_rng(3)
    big = _t({"k": rng.integers(0, 1000, n), "v": rng.normal(size=n)})
    f = _t({"k2": np.arange(1000), "w": rng.normal(size=1000)})
    for op in ("IN", "NOT IN"):
        got, want = sql_both({"t": big, "f": f}, f"SELECT count(*) c FROM t WHERE k {op} (SELECT k2 FROM f WHERE w > 2.8)")
        assert_rows_equal(got, want)


def test_dictionary_growth_union_and_join():
    a = _t({"s": [f"a{i:03d}" for i in range(500)], "v": list(range(500))})
    b = _t({"s": [f"b{i:03d}" for i in range(500)], "v": list(range(500))})
    got, want = sql_both({"x": a, "y": b}, "SELECT count(*) c FROM x JOIN y ON x.s = y.s")
    assert_rows_equal(got, want)
    assert got["c"] == [0]


def test_tiny_build_null_keys_never_match():
    jl = _t({"k": [1, 2, None, 4, None], "v": [10, 20, 30, 40, 50]})
    jr = _t({"k2": [2, None]})
    lt, rt = port_table(jl), port_table(jr)
    on = [(PhysCol("k", 0, lt.columns[0].dtype), PhysCol("k2", 0, rt.columns[0].dtype))]
    assert join_tables(lt, rt, on, "semi", None).to_pydict()["v"] == [20]
    assert join_tables(lt, rt, on, "anti", None).to_pydict()["v"] == [10, 30, 40, 50]


# ---- twins of tests/test_semi_pushdown.py --------------------------------------

SEMI_TABLES = {
    "o": {"ok": [1, 2, 3, 4], "ck": [10, 10, 20, 20]},
    "c": {"ck": [10, 20], "name": ["a", "b"]},
    "l": {"ok": [1, 1, 2, 3, 3, 3], "qty": [5, 6, 1, 9, 9, 9]},
}
SEMI_SQL = [
    "SELECT name, o.ok FROM c JOIN o ON c.ck = o.ck "
    "WHERE o.ok IN (SELECT ok FROM l GROUP BY ok HAVING sum(qty) > 10) ORDER BY o.ok",
    "SELECT name, o.ok FROM c JOIN o ON c.ck = o.ck "
    "WHERE o.ok NOT IN (SELECT ok FROM l GROUP BY ok HAVING sum(qty) > 10) ORDER BY o.ok",
    "SELECT name, o.ok FROM c JOIN o ON c.ck = o.ck "
    "WHERE EXISTS (SELECT 1 FROM l WHERE l.ok = o.ok AND l.qty > c.ck) ORDER BY o.ok",
]
SEMI_WANT = [{"name": ["a", "b"], "ok": [1, 3]}, {"name": ["a", "b"], "ok": [2, 4]}, {"name": [], "ok": []}]


@pytest.mark.parametrize("i", range(len(SEMI_SQL)))
def test_semi_anti_pushdown(i):
    tables = {n: _t(d) for n, d in SEMI_TABLES.items()}
    got, want = sql_both(tables, SEMI_SQL[i])
    assert_rows_equal(got, want)
    assert got == SEMI_WANT[i]


def test_semi_pushdown_plan_shape():
    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    for n, d in SEMI_TABLES.items():
        jctx.register_table(n, _t(d))
        pctx.register_table(n, port_table(_t(d)))
    want = jctx.optimize(jctx.create_logical_plan(SEMI_SQL[0])).display()
    got = pctx.optimize(pctx.create_logical_plan(SEMI_SQL[0])).display()
    assert got == want
    lines = got.splitlines()
    semi = next(i for i, l in enumerate(lines) if "Join(semi)" in l)
    assert "TableScan: o" in lines[semi + 1]


# ---- twins of tests/test_subquery_semantics.py ---------------------------------


def _subq_tables():
    return {
        "t": _t({"a": [1, 2, 3, None], "s": ["x", "y", "x", None]}),
        "u": _t({"s": ["x", "z"], "v": [10, 20]}),
        "un": _t({"s": ["x", None], "v": [10, 20]}),
        "ue": _t({"s": [], "v": []}, {"s": JSTRING}),
    }


@pytest.mark.parametrize("tb,want", [("u", ["y"]), ("un", []), ("ue", ["x", "y", "x", None])])
def test_null_aware_not_in(tb, want):
    got, jwant = sql_both(_subq_tables(), f"SELECT s FROM t WHERE s NOT IN (SELECT s FROM {tb})")
    assert_rows_equal(got, jwant)
    assert got == {"s": want}


def test_null_aware_not_in_correlated():
    tables = {
        "o": _t({"id": [1, 2, 3, 4, 5, 6], "g": [1, 2, 2, 2, 3, None], "x": [99, 99, 10, None, None, 5]}),
        "s": _t({"g": [1, 1, 2], "v": [10, None, 10]}),
    }
    got, want = sql_both(tables, "SELECT id FROM o WHERE x NOT IN (SELECT v FROM s WHERE s.g = o.g) ORDER BY id")
    assert_rows_equal(got, want)
    assert got == {"id": [2, 5, 6]}


@pytest.mark.parametrize("sql,want", [
    ("SELECT s FROM t WHERE s IN (SELECT s FROM un)", {"s": ["x", "x"]}),
    ("SELECT count(*) AS c FROM t WHERE s IN (SELECT s FROM u)", {"c": [2]}),
    ("SELECT count(*) AS c FROM t WHERE s IN (SELECT s FROM u WHERE v > 10)", {"c": [0]}),
    ("SELECT count(*) AS c FROM t WHERE a > (SELECT min(v) FROM u) - 9", {"c": [2]}),
    ("SELECT count(*) AS c FROM t WHERE a > (SELECT max(v) FROM u) - 18", {"c": [1]}),
])
def test_subquery_semantics(sql, want):
    got, jwant = sql_both(_subq_tables(), sql)
    assert_rows_equal(got, jwant)
    assert got == want


def test_plan_cache_distinguishes_subquery_bodies():
    pctx = D.ExecutionContext(device="cpu")
    for n, t in _subq_tables().items():
        pctx.register_table(n, port_table(t))
    a = pctx.sql("SELECT count(*) AS c FROM t WHERE s IN (SELECT s FROM u)").collect().to_pydict()
    c = pctx.sql("SELECT count(*) AS c FROM t WHERE s IN (SELECT s FROM u WHERE v > 10)").collect().to_pydict()
    assert a == {"c": [2]} and c == {"c": [0]}
