"""TPC-H Q20, the potential part promotion query.

IN and the correlated subquery are computed directly: each (part,
supplier)'s quantity shipped in 1994; an offer of a ``forest%`` part
qualifies when its available quantity exceeds half of it, compared
exactly (200 * ps_availqty > sum in cents; an offer with no such line
has no sum and does not qualify); float32 in the control.  Then the
Canadian suppliers with a qualifying offer.
"""

import torch

from ..tpchgen import days

COLUMNS = [("s_name", "str"), ("s_address", "str")]
ORDER_BY = [(0, False)]
LIMIT = None


def run(x):
    d = x.col("l_shipdate")
    width = max(int(x.col("l_suppkey").max()), int(x.col("ps_suppkey").max())) + 1
    shipped = (d >= days("1994-01-01")) & (d < days("1995-01-01"))
    inv, (pair,) = x.group((x.col("l_partkey") * width + x.col("l_suppkey"))[shipped])
    qty = x.dec("l_quantity")[shipped].sum(inv, len(pair)).v
    row, hit = x.lookup("q20.shipped", x.col("ps_partkey") * width + x.col("ps_suppkey"), keys=pair)
    avail = x.col("ps_availqty")
    enough = 200 * avail > qty[row] if x.exact else avail.to(qty.dtype) > 0.5 * qty[row]
    part, phit = x.lookup("p_partkey", x.col("ps_partkey"))
    forest = phit & x.where("p_name", lambda s: s.startswith("forest"))[x.col("p_name")[part].long()]
    supp, shit = x.lookup("s_suppkey", x.col("ps_suppkey"))
    ok = forest & hit & enough & shit
    chosen = torch.zeros(len(x.col("s_suppkey")), dtype=torch.bool, device=x.device)
    chosen[supp[ok]] = True
    nat, nhit = x.lookup("n_nationkey", x.col("s_nationkey"))
    m = chosen & nhit & (x.col("n_name")[nat] == x.code("n_name", "CANADA"))
    return [x.strings("s_name", x.col("s_name")[m]), x.strings("s_address", x.col("s_address")[m])]
