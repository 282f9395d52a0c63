"""W4, the RANGE frame of TPC-DS Q12/Q98 over TPC-H's orders: per
customer, the sum of total price over the orders placed from 90 days
before each order's date up to that date (``RANGE BETWEEN 90 PRECEDING
AND CURRENT ROW`` on the day number, so orders of the same day are peers
and each sees the others).  The timed form takes the first 100 rows in
the order of customer, day and order key.  ``run`` sorts on the device
and hands over those 100 rows (the ORDER BY columns are unique, so no row
ties with the 100th); ``full`` gives every row.  Sums are exact int64
cents."""

import torch

from . import Dec
from ._window import cut, lexsort

COLUMNS = [("o_custkey", "int"), ("o_orderkey", "int"), ("d", "int"), ("o_totalprice", "decimal:2"),
           ("spend90", "decimal:2")]
ORDER_BY = [(0, False), (2, False), (1, False)]
LIMIT = 100
PRECEDING = 90  # days


def full(x):
    day = x.col("o_orderdate").to(torch.int64)
    order = lexsort(x.col("o_custkey"), day, x.col("o_orderkey"))
    cust, day = x.col("o_custkey")[order], day[order]
    price = x.dec("o_totalprice")[order]
    # one sorted key per (customer, day): a frame is one range of it
    key = cust * (1 << 20) + day
    lo = torch.searchsorted(key, key - PRECEDING)
    hi = torch.searchsorted(key, key, right=True)
    sums = torch.cat([price.v.new_zeros(1), price.v.cumsum(0)])
    spend = Dec(sums[hi] - sums[lo], 2, price.exact)
    return [cust, x.col("o_orderkey")[order], day, price, spend], [None] * 5


def run(x):
    cols, _ = full(x)
    return cut(cols, None, [cols[0], cols[2], cols[1]], LIMIT)
