"""TPC-H Q22, the global sales opportunity query.

``substring(c_phone from 1 for 2)`` is taken from each phone string;
the scalar subquery's average balance is compared exactly (balance *
count > sum, in cents; float32 in the control); NOT EXISTS is computed
directly: customers with no order.
"""

import numpy as np
import torch

COLUMNS = [("cntrycode", "str"), ("numcust", "int"), ("totacctbal", "decimal:2")]
ORDER_BY = [(0, False)]
LIMIT = None
CODES = ("13", "31", "23", "29", "30", "18", "17")


def run(x):
    phone = x.col("c_phone").long()
    country = torch.from_numpy(np.array([int(s[:2]) if s[:2] in CODES else -1
                                         for s in x.data.vocab["c_phone"]], dtype=np.int64))
    code = country.to(x.device)[phone]
    sel = code >= 0
    bal = x.dec("c_acctbal")
    pos = sel & (bal.v > 0)
    total, n = bal.v[pos].sum(), int(pos.sum())
    rich = bal.v * n > total if bal.exact else bal.v > total / n
    cust, hit = x.lookup("c_custkey", x.col("o_custkey"))
    ordered = torch.zeros(len(phone), dtype=torch.bool, device=x.device)
    ordered[cust[hit]] = True
    m = sel & rich & ~ordered
    inv, (c,) = x.group(code[m])
    return [np.array([f"{v:02d}" for v in c.tolist()], dtype=object), x.counts(inv, len(c)),
            bal[m].sum(inv, len(c))]
