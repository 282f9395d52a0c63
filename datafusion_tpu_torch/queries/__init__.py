"""Query text carried by the package.

``q{n}.sql`` is TPC-H query n as DataFusion's benchmark writes it: Q1
with its date literal folded to ``date '1998-09-02'`` and ORDER BY
``l_returnflag, l_linestatus``; Q6 with the literal dates
``1994-01-01`` and ``1995-01-01``.  Later slices add the queries they
open.

The named queries (``<name>.sql``) are the lineitem-only work of the
single-table slice, each shaped on a TPC-H query:
``q15_revenue`` (Q15's revenue view: 10,000 supplier groups at SF1),
``q18_bigorders`` (Q18's subquery: about 1.5 M order groups, HAVING),
``linenumber`` (a GROUP BY over a small integer key, the small-domain
path), ``distinct_supp`` (a grouped ``count(DISTINCT)``) and ``exprs``
(EXTRACT, CASE and IN over a projection).
"""

from __future__ import annotations

from pathlib import Path

_DIR = Path(__file__).resolve().parent

NAMED_QUERIES = ("q6", "q15_revenue", "q18_bigorders", "linenumber", "distinct_supp", "exprs")


def get_query_sql(q: int) -> str:
    return (_DIR / f"q{q}.sql").read_text()


def get_named_query(name: str) -> str:
    """The text of one of ``NAMED_QUERIES``."""
    if name not in NAMED_QUERIES:
        raise ValueError(f"unknown query {name!r}; known: {NAMED_QUERIES}")
    return (_DIR / f"{name}.sql").read_text()
