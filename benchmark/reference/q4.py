"""TPC-H Q4, the order priority checking query.

EXISTS is computed directly: an order qualifies when any of its lines
was received after its commit date.
"""

import torch

from ..tpchgen import days

COLUMNS = [("o_orderpriority", "str"), ("order_count", "int")]
ORDER_BY = [(0, False)]
LIMIT = None


def run(x):
    order, hit = x.lookup("o_orderkey", x.col("l_orderkey"))
    late = hit & (x.col("l_commitdate") < x.col("l_receiptdate"))
    exists = torch.zeros(len(x.col("o_orderkey")), dtype=torch.bool, device=x.device)
    exists[order[late]] = True
    d = x.col("o_orderdate")
    m = exists & (d >= days("1993-07-01")) & (d < days("1993-10-01"))
    inv, (prio,) = x.group(x.col("o_orderpriority")[m])
    return [x.strings("o_orderpriority", prio), x.counts(inv, len(prio))]
