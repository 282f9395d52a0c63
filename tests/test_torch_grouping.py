"""GROUP BY in the torch port against the JAX package on the CPU, on
identical buffers: the sort path and the small-domain path that the
integer-key probe opens, over int, date, decimal, float and string keys
with NULLs, one key and several; HAVING, DISTINCT aggregates, min/max over
strings, sums that wrap mod 2^64, NaN and +-0.0 keys, OFFSET and UNION;
and the lineitem-only queries of ``datafusion_tpu_torch/queries`` over
``bench.tpch_datagen``'s lineitem at SF 0.01.

Every query also asserts its path: the JAX package's, read by wrapping its
``_fused_small_domain_aggregate`` in a recorder (the wrapper changes no
file), and the port's, which must be the same; the port's kernel K1 is
launched (its plain version here) exactly when the small-domain path has
an aggregate for it.

Tolerances: keys, counts, integer and decimal sums, min and max are
exactly equal (NaN equal to NaN, and -0.0 told from 0.0).  Float
aggregates are within rel 1e-12: the engines add in other orders (XLA's
reduction trees vs torch's, and over decimals the reference's per-row
floats vs the port's exact int64 sums in K1).
"""

import math

import numpy as np
import pytest

import datafusion_tpu as J
import datafusion_tpu.physical.fuse as jfuse
import datafusion_tpu.physical.stage_compiler as jsc
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.types.dtypes import DATE32 as JDATE32, decimal as jdecimal
import datafusion_tpu_torch as D
import datafusion_tpu_torch.ops.aggregate as pagg
import datafusion_tpu_torch.physical.fuse as pfuse
from datafusion_tpu_torch.queries import NAMED_QUERIES, get_named_query

from torch_parity import Recorder, assert_rows_equal, port_table

def run_both(jtable, ptable, sql, monkeypatch):
    """(port rows, JAX rows, JAX took the small-domain path, the port did,
    the port's K1 calls) for one query on fresh contexts and stage caches,
    so that the JAX package traces its stage anew."""
    jrec = Recorder(jsc._fused_small_domain_aggregate)
    prec = Recorder(pagg._fused_small_domain_aggregate)
    k1 = Recorder(pagg.smalldomain_sum_count)
    monkeypatch.setattr(jsc, "_fused_small_domain_aggregate", jrec)
    monkeypatch.setattr(pagg, "_fused_small_domain_aggregate", prec)
    monkeypatch.setattr(pagg, "smalldomain_sum_count", k1)
    monkeypatch.setattr(jfuse, "_STAGE_CACHE", {})
    monkeypatch.setattr(pfuse, "_STAGE_CACHE", {})
    jctx = J.ExecutionContext()
    jctx.register_table("t", jtable)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_table("t", ptable)
    want = jctx.sql(sql).collect().to_pydict()
    got = pctx.sql(sql).collect().to_pydict()
    return got, want, jrec.calls > 0, prec.calls > 0, k1.calls


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(23)
    n = 3000

    def nulls(col, p=0.1):
        return [None if z else v for z, v in zip(rng.random(n) < p, col)]

    day0 = np.datetime64("1995-01-01")
    data = {
        "s": nulls(list(rng.choice(["apple", "Banana", "cherry", "date", "elder"], n))),
        "i": nulls([int(v) for v in rng.integers(-50, 50, n)]),  # range 100: probed small
        "big": nulls([int(v) for v in rng.integers(0, 100_000, n)]),  # range 100,000: sort
        "dt": nulls([day0 + int(v) for v in rng.integers(0, 2000, n)]),  # 2,000 days: sort
        "dd": nulls([day0 + int(v) for v in rng.integers(0, 30, n)]),  # 30 days: probed small
        "d": nulls([float(v) for v in rng.integers(-10**5, 10**5, n) / 100]),
        "f": nulls([float(v) for v in rng.choice([0.0, -0.0, 1.5, np.nan, 2.25, -3.0], n)]),
        "w": [int(v) for v in rng.choice([2**62, -(2**62), 2**62 - 1, 3 * 2**61], n)],
    }
    jt = JTable.from_pydict(data, dtypes={"d": jdecimal(12, 2), "dt": JDATE32, "dd": JDATE32})
    return jt, port_table(jt)


# (sql, float columns, path: "k1" the small-domain path with kernel K1,
# "slots" the small-domain path with no aggregate for K1, "sort" the sort path)
QUERIES = [
    # one probed integer key, K1 and non-K1 aggregates, string min/max
    ("SELECT i, count(*) c, count(d) cd, sum(d) sd, avg(d) ad, min(s) ms, max(s) xs, "
     "max(dt) xd, avg(f) af, stddev(d) sdd FROM t GROUP BY i ORDER BY i", {"ad", "af", "sdd"}, "k1"),
    # a probed date key and a string key: the slot id decodes both
    ("SELECT s, dd, count(*) c, sum(w) sw, min(d) md FROM t GROUP BY s, dd ORDER BY s, dd", (), "k1"),
    # a probed key without ORDER BY: the slot order is the key order
    ("SELECT dd, max(i) mi, sum(i) si FROM t GROUP BY dd", (), "k1"),
    # over the domain limit: one key, several keys
    ("SELECT big, count(*) c, sum(w) sw, min(s) ms FROM t GROUP BY big ORDER BY big", (), "sort"),
    ("SELECT s, i, count(*) c, sum(d) sd, avg(i) ai FROM t GROUP BY s, i ORDER BY s, i", {"ai"}, "sort"),
    # (integer inputs: every moment sum is exact, so only the last steps
    # differ: XLA may fuse the moment formula's multiply-adds, and torch's
    # sqrt is fault F4)
    ("SELECT dt, s, count(*) c, stddev(i) sd, var_pop(i) vp FROM t GROUP BY dt, s ORDER BY dt, s",
     {"sd", "vp"}, "sort"),
    # decimal and float keys take the sort path; NaN rows are groups of
    # their own, -0.0 and 0.0 one group
    ("SELECT d, count(*) c, max(s) xs FROM t GROUP BY d ORDER BY d", (), "sort"),
    ("SELECT f, count(*) c, min(i) mi, sum(d) sd FROM t GROUP BY f", (), "sort"),
    # min/max over +-0.0: XLA orders -0.0 below 0.0, on every path
    ("SELECT s, min(f) mf, max(f) xf, min(f * -1) mn, max(f * -1) xn FROM t GROUP BY s", (), "slots"),
    ("SELECT big % 7 AS g, min(f) mf, max(f) xf, max(f * -1) xn FROM t GROUP BY big % 7", (), "sort"),
    ("SELECT min(f) mf, max(f) xf, min(f * -1) mn, max(f * -1) xn FROM t WHERE f = 0", (), "sort"),
    ("SELECT f, s, count(*) c FROM t GROUP BY f, s ORDER BY s, f", (), "sort"),
    # HAVING
    ("SELECT i, sum(d) sd, count(*) c FROM t GROUP BY i HAVING sum(d) > 0 AND count(*) > 25 "
     "ORDER BY i", (), "k1"),
    ("SELECT big, count(*) c FROM t GROUP BY big HAVING count(*) > 1 ORDER BY big", (), "sort"),
    # DISTINCT aggregates force the sort path, grouped and ungrouped
    ("SELECT s, count(DISTINCT i) ci, sum(DISTINCT i) si, avg(DISTINCT d) ad, "
     "count(DISTINCT f) cf, min(DISTINCT s) ms FROM t GROUP BY s ORDER BY s", {"ad"}, "sort"),
    ("SELECT i, count(DISTINCT big) cb FROM t GROUP BY i ORDER BY i", (), "sort"),
    ("SELECT count(DISTINCT i) ci, sum(DISTINCT big) sb, avg(DISTINCT d) ad, "
     "count(DISTINCT s) cs, max(DISTINCT s) xs, count(DISTINCT f) cf FROM t", {"ad"}, "sort"),
    # sums that wrap mod 2^64, both paths and no groups
    ("SELECT i, sum(w) sw FROM t GROUP BY i ORDER BY i", (), "k1"),
    ("SELECT sum(w) sw, sum(DISTINCT w) dw FROM t", (), "sort"),
    # DISTINCT over an integer column: a GROUP BY without aggregates, above
    # a projection, so neither engine probes the key
    ("SELECT DISTINCT i FROM t ORDER BY i", (), "sort"),
    ("SELECT DISTINCT big FROM t WHERE big < 5000 ORDER BY big", (), "sort"),
    # a grouping subquery under an aggregate (the outer one runs unfused)
    ("SELECT count(*) c, sum(sd) s FROM (SELECT big, sum(d) sd FROM t GROUP BY big) x", (), "sort"),
    # OFFSET and UNION
    ("SELECT i, s FROM t ORDER BY i, s NULLS FIRST LIMIT 10 OFFSET 5", (), "sort"),
    ("SELECT s, big FROM t ORDER BY big DESC OFFSET 2990", (), "sort"),
    ("SELECT i FROM t WHERE i > 40 UNION ALL SELECT big FROM t WHERE big < 100", (), "sort"),
    ("SELECT s FROM t WHERE i = 1 UNION SELECT s FROM t WHERE i = 2", (), "slots"),
    ("SELECT s, count(*) c FROM (SELECT s FROM t WHERE i < 0 UNION ALL SELECT s FROM t "
     "WHERE big < 500) u GROUP BY s ORDER BY s", (), "k1"),
]


@pytest.mark.parametrize("sql,float_cols,path", QUERIES, ids=[f"q{i}" for i in range(len(QUERIES))])
def test_grouping_matches_jax(tables, monkeypatch, sql, float_cols, path):
    got, want, jsmall, psmall, k1 = run_both(*tables, sql, monkeypatch)
    assert_rows_equal(got, want, float_cols)
    assert any(len(v) for v in want.values())
    assert jsmall == psmall == (path != "sort")
    assert (k1 > 0) == (path == "k1")


def test_signed_zero_and_nan_groups(tables, monkeypatch):
    """The +-0.0 group reports the key of its first row in stable sort
    order, in both engines; every NaN row (0/0 here: ingest reads a NaN as
    NULL) is its own group."""
    sql = ("SELECT g, count(*) c FROM (SELECT CASE WHEN f = 1.5 THEN (f - f) / (f - f) "
           "ELSE f END AS g FROM t) x GROUP BY g")
    got, want, *_ = run_both(*tables, sql, monkeypatch)
    assert_rows_equal(got, want)
    got["f"] = got["g"]
    keys = [k for k in got["f"] if k is not None]
    assert sum(1 for k in keys if k == 0.0) == 1
    nan_groups = [c for k, c in zip(got["f"], got["c"]) if k is not None and math.isnan(k)]
    assert len(nan_groups) > 1 and set(nan_groups) == {1}


@pytest.fixture(scope="module")
def unsigned_tables():
    rng = np.random.default_rng(5)
    n = 3000
    jt = JTable.from_pydict({
        "u": rng.integers(0, 2**63, n, dtype=np.uint64) + np.uint64(2**62),  # both sides of 2^63
        "u32": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        "i": rng.integers(-5, 5, n),
    })
    return jt, port_table(jt)


UNSIGNED = [
    ("SELECT u, count(*) c, sum(u) su, min(u) mu FROM t GROUP BY u ORDER BY u LIMIT 50", "sort"),
    ("SELECT i, sum(u32) s, min(u32) m, max(u32) x, avg(u32) a FROM t GROUP BY i ORDER BY i", "k1"),
    ("SELECT u - 1 AS a, u * 3 AS b, u < u + 1 AS c, u = u AS d, CASE WHEN i > 0 THEN u END AS e "
     "FROM t WHERE u > 5 ORDER BY u DESC LIMIT 40", "sort"),
    ("SELECT u32 + 1 a, u32 * 3 b, u32 > 3000000000 c, u32 / 7 d, u32 % 7 e FROM t ORDER BY u32 LIMIT 30",
     "sort"),
    ("SELECT sum(u) s, max(u32) m, count(DISTINCT u32) c FROM t", "sort"),
]


@pytest.mark.parametrize("sql,path", UNSIGNED, ids=[f"u{i}" for i in range(len(UNSIGNED))])
def test_unsigned_storage_matches_jax(unsigned_tables, monkeypatch, sql, path):
    """uint64 and uint32 keys and aggregates: sums wrap mod 2^64, and
    uint64 keys order as their int64 wrap in both engines."""
    got, want, jsmall, psmall, k1 = run_both(*unsigned_tables, sql, monkeypatch)
    assert_rows_equal(got, want, {"a"} if "avg" in sql else ())
    assert jsmall == psmall == (path != "sort") and (k1 > 0) == (path == "k1")


@pytest.fixture(scope="module")
def lineitem():
    from bench.tpch_datagen import DATE_COLUMNS, DECIMAL_COLUMNS, generate_tpch

    li = generate_tpch(0.01)["lineitem"]
    names = ["l_orderkey", "l_suppkey", "l_linenumber", "l_quantity", "l_extendedprice",
             "l_discount", "l_tax", "l_returnflag", "l_linestatus", "l_shipdate"]
    dtypes = {n: JDATE32 for n in names if n in DATE_COLUMNS}
    dtypes.update({n: jdecimal(15, 2) for n in names if n in DECIMAL_COLUMNS})
    jt = JTable.from_pydict({n: li[n] for n in names}, dtypes=dtypes)
    return jt, port_table(jt)


# the columns the engines compute as floats in another order
LINEITEM_FLOATS = {"avg_price"}


@pytest.mark.parametrize("name", NAMED_QUERIES)
def test_lineitem_queries_match_jax(lineitem, monkeypatch, name):
    """At SF 0.01 l_suppkey spans 100 values, so the probe may send
    q15_revenue to the small-domain path; whatever path the JAX package
    takes on these data, the port takes too."""
    sql = get_named_query(name).replace("lineitem", "t")
    got, want, jsmall, psmall, k1 = run_both(*lineitem, sql, monkeypatch)
    assert_rows_equal(got, want, LINEITEM_FLOATS)
    assert any(len(v) for v in want.values())
    assert jsmall == psmall
    assert (k1 > 0) == psmall
    if name in ("linenumber", "q15_revenue"):
        assert psmall  # small integer ranges at this scale
    if name in ("q18_bigorders", "distinct_supp", "exprs", "q6"):
        assert not psmall


EDGE_TABLES = {
    "empty": {"k": np.zeros(0, np.int64), "v": np.zeros(0, np.int64), "s": np.array([], dtype=object)},
    "one-row": {"k": [5], "v": [7], "s": ["a"]},
    "null-keys": {"k": [None, None, None], "v": [1, 2, 3], "s": [None, "b", None]},
    "wide-keys": {"k": [0, 10**12, -(10**12), 0], "v": [1, 2, 3, 4], "s": ["x", "y", "x", "y"]},
}
EDGE_QUERIES = [
    "SELECT k, count(*) c, sum(v) s, min(s) ms FROM t GROUP BY k ORDER BY k",
    "SELECT s, k, count(DISTINCT v) c FROM t WHERE v < 100 GROUP BY s, k ORDER BY s, k",
    "SELECT k, sum(v) s FROM t GROUP BY k HAVING sum(v) > 100",
    "SELECT count(DISTINCT k) c, sum(DISTINCT v) s FROM t",
    "SELECT k FROM t WHERE v > 1 UNION ALL SELECT k FROM t ORDER BY k LIMIT 5 OFFSET 1",
]


@pytest.mark.parametrize("sql", EDGE_QUERIES, ids=[f"e{i}" for i in range(len(EDGE_QUERIES))])
@pytest.mark.parametrize("table", list(EDGE_TABLES))
def test_edge_tables_match_jax(monkeypatch, table, sql):
    """Empty tables, one row, all-NULL keys (the probe finds no range) and
    keys too wide to probe small."""
    jt = JTable.from_pydict(EDGE_TABLES[table])
    got, want, jsmall, psmall, _ = run_both(jt, port_table(jt), sql, monkeypatch)
    assert_rows_equal(got, want)
    assert jsmall == psmall
