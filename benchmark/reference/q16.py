"""TPC-H Q16, the parts/supplier relationship query.

NOT IN and COUNT(DISTINCT) are computed directly: an offer is dropped
when its supplier's comment matches ``%Customer%Complaints%``; the
distinct suppliers per (brand, type, size) are the distinct
(brand, type, size, supplier) tuples counted per group.
"""

import torch

COLUMNS = [("p_brand", "str"), ("p_type", "str"), ("p_size", "int"), ("supplier_cnt", "int")]
ORDER_BY = [(3, True), (0, False), (1, False), (2, False)]
LIMIT = None
SIZES = (49, 14, 23, 45, 19, 3, 36, 9)


def _complaints(s: str) -> bool:
    i = s.find("Customer")
    return i >= 0 and s.find("Complaints", i + len("Customer")) >= 0


def run(x):
    part, phit = x.lookup("p_partkey", x.col("ps_partkey"))
    brand, ptype, size = (x.col(c)[part] for c in ("p_brand", "p_type", "p_size"))
    medium_polished = x.where("p_type", lambda s: s.startswith("MEDIUM POLISHED"))
    supp, shit = x.lookup("s_suppkey", x.col("ps_suppkey"))
    complained = shit & x.where("s_comment", _complaints)[x.col("s_comment")[supp].long()]
    m = (phit & (brand != x.code("p_brand", "Brand#45")) & ~medium_polished[ptype.long()]
         & torch.isin(size, torch.tensor(SIZES, dtype=size.dtype, device=x.device)) & ~complained)
    _, (b, t, s, _k) = x.group(brand[m], ptype[m], size[m], x.col("ps_suppkey")[m])
    inv, (b, t, s) = x.group(b, t, s)
    return [x.strings("p_brand", b), x.strings("p_type", t), s, x.counts(inv, len(b))]
