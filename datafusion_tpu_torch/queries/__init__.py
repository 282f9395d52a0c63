"""Query text carried by the package.

``q{n}.sql`` (n = 1..22) is TPC-H query n, written from the public TPC-H
specification in the form DataFusion's benchmark uses: the substitution
parameters of the specification's validation run, no LIMIT, Q1's date
folded to ``date '1998-09-02'``, Q13's derived table naming its columns
(``c_orders (c_custkey, c_count)``), Q15 as ``create view revenue0``, the
query and ``drop view revenue0``, and Q20's date bound written
``'date 1994-01-01' + interval '1' year`` (read as 1994-01-01 plus a
year).  ``run_tpch`` runs one.

The named queries (``<name>.sql``) are the lineitem-only work of the
single-table slice, each shaped on a TPC-H query:
``q15_revenue`` (Q15's revenue view: 10,000 supplier groups at SF1),
``q18_bigorders`` (Q18's subquery: about 1.5 M order groups, HAVING),
``linenumber`` (a GROUP BY over a small integer key, the small-domain
path), ``distinct_supp`` (a grouped ``count(DISTINCT)``) and ``exprs``
(EXTRACT, CASE and IN over a projection).

``windows.py`` holds the window and rolling-window queries over the
TPC-H tables (``WINDOW_QUERIES``, ``window_sql``).
"""

from __future__ import annotations

from pathlib import Path

from .windows import WINDOW_QUERIES, window_sql  # noqa: F401

_DIR = Path(__file__).resolve().parent

NAMED_QUERIES = ("q6", "q15_revenue", "q18_bigorders", "linenumber", "distinct_supp", "exprs")


# TPC-H queries whose ORDER BY fixes the row order (compare in order);
# the others compare as multisets
FULLY_ORDERED = {1, 3, 5, 6, 12, 14, 17, 19}
# (output column, descending) of the ordered queries' ORDER BY: Q3's and
# Q5's float revenue can tie, so their rows compare as multisets plus this
# order
ORDER_SPECS = {
    1: [(0, False), (1, False)],
    3: [(1, True), (2, False)],
    5: [(1, True)],
    6: [],
    12: [(0, False)],
    14: [],
    17: [],
    19: [],
}


def get_query_sql(q: int) -> str:
    return (_DIR / f"q{q}.sql").read_text()


def run_tpch(ctx, q: int):
    """Run TPC-H query q's statements in order (Q15 creates and drops a
    view) and return the result Table of its query."""
    result = None
    for stmt in get_query_sql(q).split(";"):
        low = stmt.lower()
        if not stmt.strip():
            continue
        if "create view" in low or "drop view" in low:
            ctx.sql(stmt)
        else:
            result = ctx.sql(stmt).collect()
    return result


def get_named_query(name: str) -> str:
    """The text of one of ``NAMED_QUERIES``."""
    if name not in NAMED_QUERIES:
        raise ValueError(f"unknown query {name!r}; known: {NAMED_QUERIES}")
    return (_DIR / f"{name}.sql").read_text()
