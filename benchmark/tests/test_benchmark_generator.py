"""The frozen generator: TPC-H's schema and value domains, sorted
vocabularies, dense keys, and the same tables from the same seed."""

import numpy as np
import pytest

from benchmark import tpchgen
from benchmark.tpchgen import KINDS, SCHEMA, days

SEED = 2**31 + 12345  # larger than 32 signed bits hold, as the driver's seeds are


@pytest.fixture(scope="module")
def data():
    return tpchgen.generate(0.01, SEED, "cpu")


def test_schema_and_sizes(data):
    assert list(data.tables) == list(SCHEMA)
    for t, cols in SCHEMA.items():
        assert list(data.tables[t]) == [c for c, _ in cols]
        n = {len(a) for a in data.tables[t].values()}
        assert len(n) == 1
    assert data.nrows("orders") == 15_000 and data.nrows("customer") == 1_500
    assert data.nrows("part") == 2_000 and data.nrows("partsupp") == 8_000
    assert data.nrows("lineitem") == 59_986  # dbgen's SF10 count, scaled: the same for every seed
    storage = {"int64": np.int64, "decimal": np.int64, "date": np.int32, "string": np.int32}
    for t, cols in data.tables.items():
        for c, a in cols.items():
            assert a.dtype == storage[KINDS[c]], c


def test_vocabularies_are_sorted_and_distinct(data):
    for c, kind in KINDS.items():
        if kind != "string":
            continue
        v = data.vocab[c]
        assert len(v) and all(isinstance(s, str) for s in v)
        assert list(v) == sorted(set(v)), c
        codes = data.tables[[t for t, cols in SCHEMA.items() if c in dict(cols)][0]][c]
        assert codes.min() >= 0 and codes.max() < len(v), c


def test_value_domains(data):
    li, o = data.tables["lineitem"], data.tables["orders"]
    assert o["o_orderdate"].min() >= days("1992-01-01") and o["o_orderdate"].max() <= days("1998-08-02")
    assert np.array_equal(o["o_orderkey"], np.arange(1, len(o["o_orderkey"]) + 1) * 4 - 3)
    assert set(np.unique(li["l_quantity"])) <= set(range(100, 5100, 100))
    assert li["l_discount"].min() >= 0 and li["l_discount"].max() <= 10
    assert li["l_tax"].min() >= 0 and li["l_tax"].max() <= 8
    assert (li["l_receiptdate"] > li["l_shipdate"]).all()
    assert np.isin(li["l_orderkey"], o["o_orderkey"]).all()
    lines = np.bincount((li["l_orderkey"] + 3) // 4 - 1, minlength=len(o["o_orderkey"]))
    assert lines.min() >= 1 and lines.max() <= 7
    assert np.array_equal(li["l_linenumber"], np.concatenate([np.arange(1, k + 1) for k in lines]))
    part = data.tables["part"]
    price = part["p_retailprice"][li["l_partkey"] - 1]
    assert np.array_equal(li["l_extendedprice"], li["l_quantity"] // 100 * price)
    ps = data.tables["partsupp"]
    pairs = set(zip(ps["ps_partkey"].tolist(), ps["ps_suppkey"].tolist()))
    assert len(pairs) == len(ps["ps_partkey"])
    assert all(p in pairs for p in zip(li["l_partkey"][:2000].tolist(), li["l_suppkey"][:2000].tolist()))
    for c in ("c_acctbal", "s_acctbal"):
        t = data.tables["customer" if c[0] == "c" else "supplier"][c]
        assert t.min() >= -99_999 and t.max() <= 999_999
    custs = set(o["o_custkey"].tolist())
    assert not any(k % 3 == 0 for k in custs)  # a third of the customers place no order
    flags = data.vocab["l_returnflag"][li["l_returnflag"]]
    late = li["l_receiptdate"] > days("1995-06-17")
    assert (flags[late] == "N").all() and set(flags[~late]) <= {"R", "A"}
    phone = data.vocab["c_phone"][data.tables["customer"]["c_phone"]]
    nation = data.tables["customer"]["c_nationkey"]
    assert all(p[:2] == str(n + 10) and len(p) == 15 for p, n in zip(phone[:200], nation[:200]))


def test_same_seed_same_tables_other_seed_other_tables(data):
    again = tpchgen.generate(0.01, SEED, "cpu")
    other = tpchgen.generate(0.01, SEED + 1, "cpu")
    for t in SCHEMA:
        for c in data.tables[t]:
            assert np.array_equal(data.tables[t][c], again.tables[t][c]), c
    assert not np.array_equal(data.tables["orders"]["o_totalprice"], other.tables["orders"]["o_totalprice"])
    assert {t: data.nrows(t) for t in SCHEMA} == {t: other.nrows(t) for t in SCHEMA}
    assert all(np.array_equal(data.vocab[c], again.vocab[c]) for c in data.vocab)
