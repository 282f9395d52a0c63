"""W1, TPC-DS Q67/Q70's rank within a partition over TPC-H's orders:
``rank()`` and ``dense_rank()`` per customer by total price, descending;
rows of equal price are peers and share a rank.  The timed form keeps
ranks up to 3, as Q67/Q70 filter on the rank, in the order of customer,
rank and order key, LIMIT 100.  ``run`` sorts on the device and hands
over those 100 rows and any tied with the 100th on every ORDER BY column
(none: the order key is unique); ``full`` gives every row."""

from ._window import cut, lexsort, runs

COLUMNS = [("o_custkey", "int"), ("o_orderkey", "int"), ("o_totalprice", "decimal:2"), ("rk", "int"),
           ("drk", "int")]
ORDER_BY = [(0, False), (3, False), (1, False)]
LIMIT = 100


def full(x):
    price = x.dec("o_totalprice")
    order = lexsort(x.col("o_custkey"), -price.v, x.col("o_orderkey"))
    cust, p = x.col("o_custkey")[order], price[order]
    _, first, _ = runs(cust)
    peer, peer_first, _ = runs(cust, p.v)
    rk = peer_first - first + 1
    drk = peer - peer[first] + 1
    return [cust, x.col("o_orderkey")[order], p, rk, drk], [None] * 5


def run(x):
    cols, _ = full(x)
    return cut(cols, cols[3] <= 3, [cols[0], cols[3], cols[1]], LIMIT)
