"""The expected rows of the 22 TPC-H queries at SF1
(``tests/data/torch_tpch_sf1_seed7.json.gz``) and of ``bench/sf_check.py``'s
nine at SF10 (``tests/data/torch_tpch_sf10_seed7.json.gz``), and their check
(``datafusion_tpu_torch/queries/expected.py``):

* the generator's SF1 tables still have the file's digests, so a change to
  ``tpchdata.py`` cannot leave the file stale unnoticed;
* ``compare`` passes equal rows and raises on each kind of difference;
* the port on the CPU at SF1 gives the file's rows for Q6 and Q14;
* the SF10 file loads, has the form ``expected.py`` writes, its entries
  were written from the port's query texts, and ``compare`` refuses a
  changed value in a result kept in full and a result kept as digests;
* (slow, about 10 minutes) ``tests/torch_expected_sf1.py`` writes the
  committed file again from the JAX package; (slow, about 2 minutes and
  15 GB of host memory) the generator's SF10 tables have the SF10 file's
  digests.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

import datafusion_tpu_torch as D
from datafusion_tpu_torch import tpchdata
from datafusion_tpu_torch.queries import FULLY_ORDERED, ORDER_SPECS, expected, get_query_sql, run_tpch

ROOT = Path(__file__).resolve().parents[1]
FILE = ROOT / "tests" / "data" / "torch_tpch_sf1_seed7.json.gz"
FILE10 = ROOT / "tests" / "data" / "torch_tpch_sf10_seed7.json.gz"
SF10_QUERIES = (1, 3, 5, 6, 7, 9, 10, 12, 18)  # bench/sf_check.py's set


@pytest.fixture(scope="module")
def doc():
    return expected.load(FILE)


@pytest.fixture(scope="module")
def doc10():
    return expected.load(FILE10)


@pytest.fixture(scope="module")
def sf1():
    return tpchdata.generate_tpch(1.0, 7)


def test_file_is_small_and_holds_the_22_queries(doc):
    assert FILE.stat().st_size < 512 * 1024
    assert (doc["sf"], doc["seed"]) == (1.0, 7)
    assert sorted(doc["queries"], key=int) == [str(q) for q in range(1, 23)]
    for q, e in doc["queries"].items():
        assert e["rows"] > 0, q
        assert ("values" in e) == (e["rows"] < expected.FULL_ROWS), q


def test_sf1_tables_have_the_file_digests(sf1, doc):
    expected.check_tables(sf1, doc)


def test_query_texts_have_the_file_digests(doc):
    """A change to a query's text makes the file stale: this names it."""
    expected.check_texts(doc, get_query_sql)
    with pytest.raises(AssertionError, match="text of Q14 is not"):
        expected.check_texts(doc, lambda q: get_query_sql(q) + (" " if q == 14 else ""))


def test_check_tables_names_the_column_that_differs(sf1, doc):
    nation = dict(sf1["nation"], n_regionkey=sf1["nation"]["n_regionkey"][::-1])
    with pytest.raises(AssertionError, match="nation column n_regionkey"):
        expected.check_tables(dict(sf1, nation=nation), doc)


COLUMNS = [("k", "int"), ("name", "str"), ("d", "date"), ("amount", "decimal:2"), ("avg", "float")]
ROWS = [(3, "c", "1995-01-02", 123456789012.34, 0.5), (1, "a", "1994-01-01", 1.5, 1000.0),
        (2, "b", "1996-03-04", -2.25, 0.0)]


def _with(rows, i, j, v):
    rows = list(rows)
    rows[i] = rows[i][:j] + (v,) + rows[i][j + 1:]
    return rows


def _result(rows, columns=COLUMNS) -> dict:
    """``rows`` as an engine's ``to_pydict()``."""
    return {n: [r[j] for r in rows] for j, (n, _) in enumerate(columns)}


def _want(rows, columns=COLUMNS, ordered=False, spec=None) -> dict:
    return expected.entry("SELECT 1", rows, columns, ordered, spec)


@pytest.mark.parametrize("got, error", [
    (_result(list(reversed(ROWS))), None),  # unordered: any order
    (_result(ROWS[:2]), "2 rows, want 3"),
    (_result(_with(ROWS, 0, 1, "x")), r"differs in \['name'\]"),
    # 123456789012.35 is within rel 1e-12 as a float: only the scaled
    # integer tells it apart
    (_result(_with(ROWS, 0, 3, 123456789012.35)), r"differs in \['amount'\]"),
    (_result(_with(ROWS, 1, 4, 1000.0 * (1 + 5e-13))), None),
    (_result(_with(ROWS, 1, 4, 1000.0 * (1 + 2e-12))), r"differs in \['avg'\]"),
    (_result(_with(ROWS, 2, 4, 5e-13)), None),  # within rel 1e-12 of max(|0.0|, 1)
    (_result(_with(ROWS, 2, 4, 2e-12)), r"differs in \['avg'\]"),
    # a renamed column, and a float where the reference has an int
    (_result(ROWS, [("key", "int")] + COLUMNS[1:]), r"columns \['key', .*want \['k', "),
    (_result(_with(ROWS, 0, 0, 3.0)), r"column k is int but holds 3.0 \(float\)"),
    # a float-computed value near, but not at, a scaled integer of a decimal
    (_result(_with(ROWS, 2, 3, -2.25 + 1e-9)), r"column amount is decimal:2 but holds -2.249999999"),
    (_result(_with(ROWS, 1, 1, 1)), r"column name is str but holds 1 \(int\)"),
])
def test_compare_full_rows(got, error):
    want = _want(ROWS)
    if error is None:
        expected.compare("t", got, want)
    else:
        with pytest.raises(AssertionError, match=error):
            expected.compare("t", got, want)


def test_compare_ordered_rows_with_ties():
    """An ordered result compares as a multiset in its ORDER BY order: rows
    that tie on the sort key may come in either order (Q3's revenue)."""
    cols = [("k", "int"), ("revenue", "decimal:4")]
    rows = [(7, 9.5), (1, 9.5), (4, 2.0)]
    want = _want(rows, cols, True, [(1, True)])
    expected.compare("t", _result(rows, cols), want)
    expected.compare("t", _result([rows[1], rows[0], rows[2]], cols), want)
    with pytest.raises(AssertionError, match="out of order on column 1"):
        expected.compare("t", _result([rows[2], rows[0], rows[1]], cols), want)
    with pytest.raises(AssertionError, match=r"differs in \['k'\]"):
        expected.compare("t", _result([(7, 9.5), (2, 9.5), (4, 2.0)], cols), want)


def test_compare_digest_entries():
    n = expected.FULL_ROWS
    cols = [("k", "int"), ("s", "str"), ("f", "float")]
    rows = [(i, f"s{i % 7}", i / 3) for i in range(n)]
    want = _want(rows, cols)
    assert "values" not in want and want["rows"] == n
    expected.compare("t", _result(rows[::-1], cols), want)
    with pytest.raises(AssertionError, match="column s differs from the expected digest"):
        expected.compare("t", _result(_with(rows, 5, 1, "s9"), cols), want)
    with pytest.raises(AssertionError, match="row 5 of 1000 .*column f"):
        expected.compare("t", _result(_with(rows, 5, 2, 5 / 3 + 1e-9), cols), want)
    with pytest.raises(AssertionError, match="999 rows, want 1000"):
        expected.compare("t", _result(rows[1:], cols), want)


def test_port_on_the_cpu_at_sf1(sf1, doc):
    """Q6 and Q14 at SF1 through the port on the CPU: the file's rows."""
    ctx = D.ExecutionContext(device="cpu")
    tpchdata.register_tpch(ctx, {t: sf1[t] for t in ("lineitem", "part")})
    for q in (6, 14):
        expected.compare(f"Q{q}", run_tpch(ctx, q).to_pydict(), doc["queries"][str(q)])


@pytest.mark.slow
def test_generator_reproduces_the_file(tmp_path, doc):
    out = tmp_path / "expected.json.gz"
    subprocess.run([sys.executable, str(ROOT / "tests" / "torch_expected_sf1.py"), "--write",
                    "--out", str(out)], check=True, cwd=tmp_path, timeout=3600)
    assert expected.load(out) == doc


def test_sf10_file_has_the_nine_queries_in_expected_form(doc10):
    assert FILE10.stat().st_size < 512 * 1024
    assert (doc10["sf"], doc10["seed"]) == (10.0, 7)
    assert (doc10["host_tables"], doc10["morsel_rows"]) == (["lineitem", "orders"], 1 << 20)
    assert sorted(doc10["tables"]) == sorted(tpchdata.generate_tpch(0.001, 7))
    assert sorted(doc10["queries"], key=int) == [str(q) for q in SF10_QUERIES]
    for q, e in doc10["queries"].items():
        kinds = [k for _, k in e["columns"]]
        assert e["rows"] > 0, q
        assert e["ordered"] == (int(q) in FULLY_ORDERED), q
        assert e["order_spec"] == [list(x) for x in ORDER_SPECS.get(int(q)) or []], q
        if e["rows"] < expected.FULL_ROWS:
            assert len(e["values"]) == e["rows"] and {len(r) for r in e["values"]} == {len(kinds)}, q
        else:
            assert "values" not in e, q
            assert sorted(e["column_digests"], key=int) == [str(j) for j, k in enumerate(kinds) if k != "float"]
            assert sorted(e["floats"], key=int) == [str(j) for j, k in enumerate(kinds) if k == "float"]
            assert all(len(v) == e["rows"] for v in e["floats"].values()), q


def test_sf10_query_texts_have_the_file_digests(doc10):
    expected.check_texts(doc10, get_query_sql)


def test_sf10_compare_refuses_a_changed_value(doc10):
    """Q1 is kept in full: its own rows pass and one changed count is
    refused.  Q3 is kept as digests (113k rows): rows of the right count
    and kinds but other values are refused, naming the first column."""
    want = doc10["queries"]["1"]
    names = [n for n, _ in want["columns"]]
    rows = [tuple(r) for r in want["values"]]
    expected.compare("Q1", _result(rows, want["columns"]), want)
    j = names.index("count_order")
    with pytest.raises(AssertionError, match=r"differs in \['count_order'\]"):
        expected.compare("Q1", _result(_with(rows, 2, j, rows[2][j] + 1), want["columns"]), want)
    want = doc10["queries"]["3"]
    assert "column_digests" in want
    fake = {"int": 1, "str": "x", "date": "1995-03-15", "float": 1.0}
    row = tuple(fake.get(k, 100) for _, k in want["columns"])
    with pytest.raises(AssertionError, match=f"column {want['columns'][0][0]} differs from the expected digest"):
        expected.compare("Q3", _result([row] * want["rows"], want["columns"]), want)


@pytest.mark.slow
def test_sf10_tables_have_the_file_digests(doc10):
    expected.check_tables(tpchdata.generate_tpch(10.0, 7), doc10)
