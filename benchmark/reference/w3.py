"""W3, TPC-DS Q47/Q57's moving frame with lag and lead over TPC-H's
lineitem: per part, in the order of ship date, order key and line number,
the mean, least and greatest quantity of the rows from 3 before to 3
after the current one, and the extended price of the row before and of
the row after (NULL at the partition's first and last row).  The timed
form keeps the rows that have both neighbours, as Q47/Q57 keep a row only
where their self-joins find the rows ranked one before and one after it,
in the order of part, order key and line number, LIMIT 100.  ``run``
sorts on the device and hands over those 100 rows (the ORDER BY columns
are unique, so no row ties with the 100th); ``full`` gives every row.
The mean is the exact sum of int64 cents over the row count, in
float64."""

import torch

from . import Dec
from ._window import cut, lexsort, runs

COLUMNS = [("l_partkey", "int"), ("l_orderkey", "int"), ("l_linenumber", "int"), ("avg_q", "float"),
           ("min_q", "decimal:2"), ("max_q", "decimal:2"), ("prev_p", "decimal:2"),
           ("next_p", "decimal:2")]
ORDER_BY = [(0, False), (1, False), (2, False)]
LIMIT = 100
REACH = 3  # ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING


def full(x):
    order = lexsort(x.col("l_partkey"), x.col("l_shipdate"), x.col("l_orderkey"), x.col("l_linenumber"))
    part = x.col("l_partkey")[order]
    qty, price = x.dec("l_quantity")[order], x.dec("l_extendedprice")[order]
    _, first, last = runs(part)
    n = len(part)
    i = torch.arange(n, device=part.device)
    lo, hi = torch.maximum(i - REACH, first), torch.minimum(i + REACH, last)
    sums = torch.cat([qty.v.new_zeros(1), qty.v.cumsum(0)])
    count = hi - lo + 1
    if qty.exact:
        avg = (sums[hi + 1] - sums[lo]).to(torch.float64) / 10 ** qty.scale / count.to(torch.float64)
    else:
        avg = (sums[hi + 1] - sums[lo]) / count.to(torch.float32)
    least, most = qty.v.clone(), qty.v.clone()
    for d in range(-REACH, REACH + 1):
        j = torch.clamp(i + d, 0, max(n - 1, 0))
        inside = (i + d >= lo) & (i + d <= hi)
        least = torch.where(inside, torch.minimum(least, qty.v[j]), least)
        most = torch.where(inside, torch.maximum(most, qty.v[j]), most)
    has_prev, has_next = i > first, i < last
    prev = torch.where(has_prev, price.v[torch.clamp(i - 1, min=0)], 0)
    nxt = torch.where(has_next, price.v[torch.clamp(i + 1, max=max(n - 1, 0))], 0)
    cols = [part, x.col("l_orderkey")[order], x.col("l_linenumber")[order], avg,
            Dec(least, 2, qty.exact), Dec(most, 2, qty.exact), Dec(prev, 2, price.exact),
            Dec(nxt, 2, price.exact)]
    return cols, [None] * 6 + [has_prev, has_next]


def run(x):
    cols, valid = full(x)
    return cut(cols, valid[6] & valid[7], [cols[0], cols[1], cols[2]], LIMIT)
