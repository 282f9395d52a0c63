"""TPC-H Q13, the customer distribution query.

The left outer join is computed directly: every customer's count of
orders whose comment does not match ``%special%requests%``, zero for a
customer with none; then the customers per count.
"""

import torch

COLUMNS = [("c_count", "int"), ("custdist", "int")]
ORDER_BY = [(1, True), (0, True)]
LIMIT = None


def _special_requests(s: str) -> bool:
    i = s.find("special")
    return i >= 0 and s.find("requests", i + len("special")) >= 0


def run(x):
    ok = ~x.where("o_comment", _special_requests)[x.col("o_comment").long()]
    cust, hit = x.lookup("c_custkey", x.col("o_custkey"))
    m = hit & ok
    n_cust = len(x.col("c_custkey"))
    c_count = torch.zeros(n_cust, dtype=torch.int64, device=x.device).index_add_(
        0, cust[m], torch.ones_like(cust[m]))
    inv, (count,) = x.group(c_count)
    return [count, x.counts(inv, len(count))]
