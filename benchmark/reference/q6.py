"""TPC-H Q6, the forecasting revenue change query.

The text's bounds ``0.06 - 0.01`` and ``0.06 + 0.01`` are arithmetic on
SQL numeric literals, which DataFusion's dialect reads as Float64, as the
port does: they are 0.049999999999999996 and 0.06999999999999999, and a
discount of 0.07 falls outside.
"""

import torch

from ..tpchgen import days

COLUMNS = [("revenue", "decimal:4")]
ORDER_BY = []
LIMIT = None


def run(x):
    d, disc, qty = x.col("l_shipdate"), x.dec("l_discount"), x.dec("l_quantity")
    as_f64 = disc.v.to(torch.float64) / (100 if disc.exact else 1)
    m = ((d >= days("1994-01-01")) & (d < days("1995-01-01")) & (as_f64 >= 0.06 - 0.01)
         & (as_f64 <= 0.06 + 0.01) & (qty.v < x.lit(24, 2)))
    return [(x.dec("l_extendedprice") * disc)[m].total()]
