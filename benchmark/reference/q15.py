"""TPC-H Q15, the top supplier query, in the specification's WITH form
(one statement; the view's columns named by aliases inside it).

The scalar subquery is computed directly: the largest revenue of the
quarter; every supplier whose revenue equals it is a row.
"""

from ..tpchgen import days

COLUMNS = [("s_suppkey", "int"), ("s_name", "str"), ("s_address", "str"), ("s_phone", "str"),
           ("total_revenue", "decimal:4")]
ORDER_BY = [(0, False)]
LIMIT = None


def run(x):
    d = x.col("l_shipdate")
    m = (d >= days("1996-01-01")) & (d < days("1996-04-01"))
    inv, (key,) = x.group(x.col("l_suppkey")[m])
    revenue = (x.dec("l_extendedprice") * x.dec("l_discount").one_minus())[m].sum(inv, len(key))
    top = revenue.v == revenue.v.max()
    supp, hit = x.lookup("s_suppkey", key[top])
    s = supp[hit]
    return [x.col("s_suppkey")[s], x.strings("s_name", x.col("s_name")[s]),
            x.strings("s_address", x.col("s_address")[s]), x.strings("s_phone", x.col("s_phone")[s]),
            revenue[top][hit]]
