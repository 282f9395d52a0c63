"""W2, TPC-DS Q51's running sum over TPC-H's lineitem: the sum of extended
price per supplier over every row up to the current one in the order of
ship date, order key and line number.  The timed form takes the first 100
rows in the order of supplier and that order.  ``run`` sorts on the
device and hands over those 100 rows (the ORDER BY columns are unique, so
no row ties with the 100th); ``full`` gives every row.  Money is int64
cents, so the sums are exact."""

from . import Dec
from ._window import cut, lexsort, runs

COLUMNS = [("l_suppkey", "int"), ("l_orderkey", "int"), ("l_linenumber", "int"), ("l_shipdate", "date"),
           ("cume", "decimal:2")]
ORDER_BY = [(0, False), (3, False), (1, False), (2, False)]
LIMIT = 100


def full(x):
    order = lexsort(x.col("l_suppkey"), x.col("l_shipdate"), x.col("l_orderkey"), x.col("l_linenumber"))
    supp = x.col("l_suppkey")[order]
    price = x.dec("l_extendedprice")[order]
    _, first, _ = runs(supp)
    total = price.v.cumsum(0)
    cume = Dec(total - total[first] + price.v[first], 2, price.exact)
    return [supp, x.col("l_orderkey")[order], x.col("l_linenumber")[order], x.col("l_shipdate")[order],
            cume], [None] * 5


def run(x):
    cols, _ = full(x)
    return cut(cols, None, [cols[0], cols[3], cols[1], cols[2]], LIMIT)
