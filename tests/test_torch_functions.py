"""Scalar functions and the rest of the expression layer in the torch port
against the JAX package on the CPU, on identical buffers: every family of
``functions/registry.py::dispatch_scalar`` (math, generic, datetime,
string with literal and with column arguments, hashing, concat), CASE, IN
lists, casts to strings and calendar-month interval arithmetic; and twins
of tests/test_functions.py.

Tolerances: integers, strings, booleans, dates and timestamps are exactly
equal.  Float results are within rel 1e-12 (XLA's and torch's math
libraries may round the last bit differently); ``sqrt`` is held to 2 ulp,
rel 4.5e-16: torch's CPU float64 square root is not correctly rounded for
every input (fault F4).
"""

import datetime as dt
import math

import numpy as np
import pytest

import datafusion_tpu as J
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.types.dtypes import DATE32 as JDATE32, decimal as jdecimal
import datafusion_tpu_torch as D

from torch_parity import port_table

REL = 1e-12
SQRT_REL = 4.5e-16


@pytest.fixture(scope="module")
def contexts():
    rng = np.random.default_rng(31)
    n = 500

    def nulls(col, p=0.1):
        return [None if z else v for z, v in zip(rng.random(n) < p, col)]

    words = ["  apple ", "Banana", "cherry-pie", "date", "a-b-c", "", "x_y z", "Élan"]
    days = [np.datetime64(d) for d in ("2000-01-31", "2000-02-29", "1999-12-31", "1970-01-01",
                                       "1969-12-31", "2024-03-15", "1995-06-17", "2100-02-28")]
    data = {
        "s": nulls(list(rng.choice(words, n))),
        "s2": nulls(list(rng.choice(["a", "an", "-", "e", "zz"], n))),
        "i": nulls([int(v) for v in rng.integers(-5, 12, n)]),
        "big": nulls([int(v) for v in rng.integers(0, 10**6, n)]),
        "f": nulls([float(v) for v in rng.choice([0.5, 1.5, 2.5, -0.5, -2.5, 0.25, -0.75, 0.0, 3.0], n)]),
        "d": nulls([float(v) for v in rng.integers(-10**4, 10**4, n) / 100]),
        "dt": nulls([days[int(v)] for v in rng.integers(0, len(days), n)]),
        "us": [int(v) for v in rng.integers(-10**15, 4 * 10**15, n)],
    }
    jt = JTable.from_pydict(data, dtypes={"d": jdecimal(12, 2), "dt": JDATE32})
    jctx = J.ExecutionContext()
    jctx.register_table("t", jt)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_table("t", port_table(jt))
    return jctx, pctx


def _check(got: dict, want: dict, exact_floats=(), sqrt_cols=()):
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for x, y in zip(got[k], want[k]):
            if isinstance(y, float) and x is not None:
                if math.isnan(y):
                    assert math.isnan(x), (k, x, y)
                    continue
                rel = 0.0 if k in exact_floats else SQRT_REL if k in sqrt_cols else REL
                assert abs(x - y) <= rel * max(abs(y), 1e-300), (k, x, y)
            else:
                assert x == y, (k, x, y)


# (sql, float columns that must be exactly equal, sqrt columns)
FAMILIES = {
    "math": (
        "SELECT sqrt(big) q1, sqrt(d) q2, sqrt(f) q3, sin(d) a, cos(d) b, tan(d) c, "
        "asin(f / 4) e, acos(f / 4) g, atan(d) h, exp(f) k, ln(big) l, log(big) m, log10(d) n, "
        "log2(big) o, power(d, 2) p, pow(i, 3) p2, atan2(d, i) r, abs(i) ai, abs(d) ad, abs(f) af, "
        "signum(i) si, signum(f) sf, floor(f) fl, ceil(f) ce, round(f) rf, trunc(f) tf, "
        "floor(d) fd, ceil(d) cd, round(d) rd, trunc(d) td, round(i) ri, floor(big) fb FROM t",
        {"af", "sf", "fl", "ce", "rf", "tf"}, {"q1", "q2", "q3"},
    ),
    "generic": (
        "SELECT nullif(i, 3) n1, nullif(s, 'date') n2, coalesce(i, big, 0) c1, "
        "coalesce(s, s2, 'none') c2, coalesce(f, d) c3, isnull(i) n3 FROM t",
        (), (),
    ),
    "datetime": (
        "SELECT extract(year from dt) y, extract(quarter from dt) q, extract(month from dt) mo, "
        "extract(day from dt) dd, extract(week from dt) w, extract(doy from dt) dy, "
        "extract(dow from dt) dw, date_part('year', dt) dpy, datepart('month', dt) dpm, "
        "date_trunc('year', dt) ty, date_trunc('quarter', dt) tq, date_trunc('month', dt) tm, "
        "date_trunc('week', dt) tw, date_trunc('day', dt) td, "
        "to_timestamp_seconds(big) s1, to_timestamp_millis(big) s2, "
        "extract(hour from to_timestamp_micros(us)) h, extract(minute from to_timestamp_micros(us)) mi, "
        "extract(second from to_timestamp_micros(us)) sc, extract(year from to_timestamp_micros(us)) ty2, "
        "extract(epoch from to_timestamp_micros(us)) ep, date_trunc('hour', to_timestamp_micros(us)) th, "
        "date_trunc('month', to_timestamp_micros(us)) tmo, date_trunc('second', to_timestamp_micros(us)) ts "
        "FROM t",
        (), (),
    ),
    "intervals": (
        "SELECT dt + INTERVAL '1' MONTH m1, dt - INTERVAL '1' MONTH m2, dt + INTERVAL '13' MONTH m3, "
        "dt + INTERVAL '1' YEAR y1, dt - INTERVAL '25' MONTH m4, dt + INTERVAL '3' DAY d3, "
        "to_timestamp_micros(us) + INTERVAL '1' MONTH tm, to_timestamp_micros(us) - INTERVAL '2' YEAR ty "
        "FROM t",
        (), (),
    ),
    "string": (
        "SELECT upper(s) a, lower(s) b, trim(s) c, btrim(s) c2, ltrim(s) e, rtrim(s) g, reverse(s) h, "
        "initcap(s) k, md5(s) l, sha224(s) m, sha256(s) n, sha384(s) o, sha512(s) p, "
        "character_length(s) q, char_length(s) r, length(s) u, bit_length(s) v, octet_length(s) w, "
        "ascii(s) x, substr(s, 2, 3) y, substring(s, 3) z, left(s, 2) l1, left(s, -2) l2, "
        "right(s, 3) r1, right(s, -1) r2, lpad(s, 9, '*') lp, rpad(s, 4) rp, repeat(s, 2) rep, "
        "replace(s, 'a', 'A') rpl, translate(s, 'ae', 'AE') tr, split_part(s, '-', 2) sp, "
        "starts_with(s, 'ch') sw, strpos(s, 'e') pos, regexp_replace(s, '[aeiou]', '_', 'g') rr, "
        "regexp_replace(s, '[aeiou]', '#') rr1, regexp_match(s, '[a-c]+') rm FROM t",
        (), (),
    ),
    "string-columns": (
        "SELECT substr(s, i) a, substr(s, i, 2) b, left(s, i) c, right(s, i) e, lpad(s, i, '*') g, "
        "repeat(s2, i) h, starts_with(s, s2) k, strpos(s, s2) l, replace(s, s2, '+') m, "
        "split_part(s, s2, 1) o FROM t WHERE i >= 0",
        (), (),
    ),
    "host": (
        "SELECT to_hex(big) a, chr(i + 70) b, concat(s, '-', i) c, concat(s, d, dt) e, "
        "concat_ws('/', s, s2, i) g, concat_ws(NULL, s) h, "
        "CAST(i AS VARCHAR) ci, CAST(d AS VARCHAR) cd, CAST(dt AS VARCHAR) cdt, "
        "CAST(f AS VARCHAR) cf, CAST(big AS VARCHAR) cb FROM t",
        (), (),
    ),
    "case-in": (
        "SELECT CASE WHEN i > 5 THEN 'big' WHEN i < 0 THEN 'neg' END a, "
        "CASE WHEN i > 5 THEN s ELSE s2 END b, CASE s WHEN 'date' THEN 1 WHEN 'Banana' THEN 2 ELSE 0 END c, "
        "CASE WHEN f > 0 THEN d ELSE 0 END e, CASE i WHEN 3 THEN f END g, "
        "i IN (1, 2, 3) h, i NOT IN (1, 2) k, s IN ('date', 'Banana', 'nope') l, "
        "s NOT IN ('date') m, d IN (1.5, 2, -3.25) o, i IN (1, NULL) p, i NOT IN (1, NULL) q, "
        "dt IN (DATE '2000-02-29', DATE '1970-01-01') r, i IN (i, 4) u FROM t",
        (), (),
    ),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(contexts, family):
    jctx, pctx = contexts
    sql, exact_floats, sqrt_cols = FAMILIES[family]
    want = jctx.sql(sql).collect().to_pydict()
    got = pctx.sql(sql).collect().to_pydict()
    assert len(next(iter(want.values()))) > 100
    _check(got, want, exact_floats, sqrt_cols)


def test_casts_to_strings_run_outside_the_fused_stage(contexts):
    """A cast to a string reads the column on the host, so the port keeps
    it out of the fused stage.  The JAX package fuses it and raises there,
    so the rows are checked against its unfused run: a concat makes its
    projection run outside the stage."""
    jctx, pctx = contexts
    cols = "CAST(i AS VARCHAR) ci, CAST(d AS VARCHAR) cd, CAST(dt AS VARCHAR) cdt"
    want = jctx.sql(f"SELECT {cols}, concat(s) c FROM t").collect().to_pydict()
    got = pctx.sql(f"SELECT {cols} FROM t").collect().to_pydict()
    want.pop("c")
    _check(got, want)
    assert "-0.0" in pctx.sql("SELECT CAST(f * -1 AS VARCHAR) x FROM t WHERE f = 0").collect().to_pydict()["x"]


def test_round_is_half_to_even_and_log_is_log10(contexts):
    _, pctx = contexts
    out = pctx.sql("SELECT round(f) r, f, log(100.0) l FROM t WHERE f IN (0.5, 1.5, 2.5, -2.5)").collect()
    d = out.to_pydict()
    assert {(f, r) for f, r in zip(d["f"], d["r"])} <= {(0.5, 0.0), (1.5, 2.0), (2.5, 2.0), (-2.5, -2.0)}
    assert set(d["l"]) == {2.0}


def test_random_and_now(contexts):
    _, pctx = contexts
    d = pctx.sql("SELECT random() r, now() n FROM t").collect().to_pydict()
    assert len(d["r"]) == 500 and all(0.0 <= r < 1.0 for r in d["r"])
    assert abs((d["n"][0] - dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)).total_seconds()) < 600


def test_array_constructor_raises_naming_its_slice():
    """Twin of test_functions.py::test_array_constructor_numeric_and_null:
    fixed-size list columns are ported in slice 5."""
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table("t", D.Table.from_pydict({"a": [1, 2, 3], "b": [4.0, None, 6.0]}, device="cpu"))
    with pytest.raises(NotImplementedError, match="slice 5"):
        ctx.sql("SELECT array(a, b) AS ab FROM t").collect()


def test_convert_tz_literal_and_column_shift():
    """Twin of the reference test of the same name: convert_tz(ts,
    '+HH:MM') adds (hour*60 + signum(hour)*minute) minutes."""
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table(
        "t",
        D.Table.from_pydict(
            {"d": ["2021-03-04 05:06:07", "2022-01-01 00:00:00"], "s": ["+05:30", "-03:15"]},
            device="cpu",
        ),
    )
    lit = ctx.sql("SELECT convert_tz(CAST(d AS TIMESTAMP), '+05:30') AS a FROM t").collect().to_pydict()
    assert lit["a"] == [dt.datetime(2021, 3, 4, 10, 36, 7), dt.datetime(2022, 1, 1, 5, 30)]
    col = ctx.sql("SELECT convert_tz(CAST(d AS TIMESTAMP), s) AS b FROM t").collect().to_pydict()
    assert col["b"] == [dt.datetime(2021, 3, 4, 10, 36, 7), dt.datetime(2021, 12, 31, 20, 45)]
    zero = ctx.sql("SELECT convert_tz(CAST(d AS TIMESTAMP), '-00:30') AS z FROM t").collect().to_pydict()
    assert zero["z"][0] == dt.datetime(2021, 3, 4, 5, 6, 7)


@pytest.mark.parametrize(
    "sql,slice_no",
    [
        ("SELECT twice(a) AS x FROM t", 5),
        ("SELECT array(a, a) AS x FROM t", 5),
        ("CREATE EXTERNAL TABLE f (a BIGINT) STORED AS CSV LOCATION 'f.csv'", 6),
    ],
)
def test_deferred_work_names_its_slice(sql, slice_no):
    """What is not ported yet names the slice that ports it (windows run:
    test_torch_window.py)."""
    from datafusion_tpu_torch.functions.udf import create_udf
    from datafusion_tpu_torch.types.dtypes import INT64

    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table("t", D.Table.from_pydict({"a": [1, 2, 3]}, device="cpu"))
    ctx.register_udf(create_udf("twice", [INT64], INT64, lambda x: x * 2))
    with pytest.raises(Exception, match=f"slice {slice_no}"):
        ctx.sql(sql).collect()


def test_joins_and_cross_joins_run():
    """Joins and cross joins, deferred until the join slice, now run."""
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table("t", D.Table.from_pydict({"a": [1, 2, 3]}, device="cpu"))
    got = ctx.sql("SELECT x.a FROM t x JOIN t y ON x.a = y.a").collect().to_pydict()
    assert got == {"a": [1, 2, 3]}
    got = ctx.sql("SELECT x.a FROM t x, t y").collect().to_pydict()
    assert got == {"a": [1, 1, 1, 2, 2, 2, 3, 3, 3]}


def test_string_results_keep_one_dictionary_across_runs():
    """What a string function or LIKE derives from a dictionary is computed
    once per dictionary and literal arguments: a second run gets the same
    output dictionary object (fused tails cache their output dictionaries
    by identity), and other arguments get their own."""
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table("t", D.Table.from_pydict({"s": ["apple", "kiwi", None, "fig"]}, device="cpu"))
    a = ctx.sql("SELECT substr(s, 1, 2) AS x FROM t").collect()
    b = ctx.sql("SELECT substr(s, 1, 2) AS x FROM t").collect()
    c = ctx.sql("SELECT substr(s, 2, 2) AS y FROM t").collect()
    assert a.columns[0].dictionary is b.columns[0].dictionary
    assert a.to_pydict() == {"x": ["ap", "ki", None, "fi"]}
    assert c.to_pydict() == {"y": ["pp", "iw", None, "ig"]}
    got = [ctx.sql(f"SELECT s LIKE '{p}' AS m{i % 2} FROM t").collect().to_pydict()[f"m{i % 2}"]
           for i, p in enumerate(("%i%", "k%", "%i%"))]
    assert got == [[False, True, None, True], [False, True, None, False], [False, True, None, True]]


def test_stage_cache_keys_on_the_plan_display_as_the_reference():
    """Fault F8 of the reference, kept: the fused-stage cache keys on the
    plan's display, where a projection shows its output names only, so a
    second query that differs only in a projected literal reuses the first
    one's stage and returns its rows, in the JAX package and in the port."""
    jt = JTable.from_pydict({"i": [1, 2, 3, 4]})
    out = []
    for ctx in (J.ExecutionContext(), D.ExecutionContext(device="cpu")):
        ctx.register_table("t", jt if isinstance(ctx, J.ExecutionContext) else port_table(jt))
        out.append([ctx.sql(f"SELECT i + {k} AS f8 FROM t").collect().to_pydict()["f8"] for k in (7, 8)])
    assert out[1] == out[0] == [[8, 9, 10, 11], [8, 9, 10, 11]]
