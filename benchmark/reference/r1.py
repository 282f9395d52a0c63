"""R1, Cube's ``rollingWindow { trailing: '7 day' }`` as CubeStore's
``ROLLING_WINDOW``: for every ship mode and every day from 8036
(1992-01-02) to 10561 (1998-12-01), the sum of extended price over the
lineitem rows of that mode shipped on that day or the 6 days before.  A
day whose 7 days hold no row of the mode is NULL, in CubeStore's
semantics.  The result (17,682 rows over TPC-H's 7 modes) is returned
whole, with no ORDER BY.

``full`` gives that NULL mask.  The comparison carries no NULL, so
``run`` gives such a day's sum as the sum over no rows, 0, and a NULL in
the program's answer fails the comparison whatever the reference says;
at SF10 each mode ships about 29 rows on the grid's first day, the
sparsest, and no frame is empty."""

import torch

from . import Dec

COLUMNS = [("l_shipmode", "str"), ("day", "int"), ("s7", "decimal:2")]
ORDER_BY = []
LIMIT = None
FROM, TO, PRECEDING = 8036, 10561, 6


def full(x):
    codes = x.col("l_shipmode").to(torch.int64)
    day = x.col("l_shipdate").to(torch.int64) - FROM
    price = x.dec("l_extendedprice")
    ndays = TO - FROM + 1
    modes = torch.unique(codes)
    mode = torch.searchsorted(modes, codes)
    inside = (day >= 0) & (day < ndays)
    cell = (mode * ndays + day)[inside]
    cells = len(modes) * ndays
    sums = torch.zeros(cells, dtype=price.v.dtype, device=codes.device).index_add_(0, cell, price.v[inside])
    rows = torch.zeros(cells, dtype=torch.int64, device=codes.device).index_add_(
        0, cell, torch.ones_like(cell))

    def trailing(per_day):
        run = torch.cumsum(per_day.reshape(len(modes), ndays), 1)
        before = torch.cat([run.new_zeros(len(modes), PRECEDING + 1), run[:, :-(PRECEDING + 1)]], 1)
        return (run - before).reshape(-1)

    s7, n7 = trailing(sums), trailing(rows)
    grid = torch.arange(cells, device=codes.device)
    cols = [x.strings("l_shipmode", modes[grid // ndays]), grid % ndays + FROM, Dec(s7, 2, price.exact)]
    return cols, [None, None, n7 > 0]


def run(x):
    return full(x)[0]
