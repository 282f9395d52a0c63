"""TPC-H Q21, the suppliers who kept orders waiting query, with the
specification's row limit (100).

EXISTS and NOT EXISTS with their residual ``l_suppkey <>`` are computed
directly from each order's count of distinct suppliers and of distinct
suppliers with a late line: a late line of supplier s has another
supplier in its order when the order has two or more, and no other late
supplier when the order has exactly one (s).  The counts come from the
distinct (order, supplier) keys, so no step pairs an order's lines.
"""

import torch

COLUMNS = [("s_name", "str"), ("numwait", "int")]
ORDER_BY = [(1, True), (0, False)]
LIMIT = 100


def _suppliers_per_order(okey: torch.Tensor, skey: torch.Tensor, width: int):
    """(orders, count): each order key with a line in ``okey``, sorted, and
    its number of distinct suppliers."""
    pairs = torch.unique(okey * width + skey)
    return torch.unique_consecutive(pairs // width, return_counts=True)


def run(x):
    okey, skey = x.col("l_orderkey"), x.col("l_suppkey")
    width = int(skey.max()) + 1
    late = x.col("l_receiptdate") > x.col("l_commitdate")
    all_o, all_n = _suppliers_per_order(okey, skey, width)
    late_o, late_n = _suppliers_per_order(okey[late], skey[late], width)
    order, ohit = x.lookup("o_orderkey", okey)
    supp, shit = x.lookup("s_suppkey", skey)
    nat, nhit = x.lookup("n_nationkey", x.col("s_nationkey")[supp])
    m = (late & ohit & (x.col("o_orderstatus")[order] == x.code("o_orderstatus", "F")) & shit & nhit
         & (x.col("n_name")[nat] == x.code("n_name", "SAUDI ARABIA")))
    k = okey[m]
    # every such order has a line and a late line: it is in both lists
    m2 = (all_n[torch.searchsorted(all_o, k)] >= 2) & (late_n[torch.searchsorted(late_o, k)] == 1)
    inv, (name,) = x.group(x.col("s_name")[supp[m]][m2])
    return [x.strings("s_name", name), x.counts(inv, len(name))]
