"""TPC-H Q3, the shipping priority query (no LIMIT)."""

from ..tpchgen import days

COLUMNS = [("l_orderkey", "int"), ("revenue", "decimal:4"), ("o_orderdate", "date"),
           ("o_shippriority", "int")]
ORDER_BY = [(1, True), (2, False)]
LIMIT = None


def run(x):
    cust, hit = x.lookup("c_custkey", x.col("o_custkey"))
    building = x.col("c_mktsegment") == x.code("c_mktsegment", "BUILDING")
    orders = hit & building[cust] & (x.col("o_orderdate") < days("1995-03-15"))
    order, hit = x.lookup("o_orderkey", x.col("l_orderkey"))
    m = hit & orders[order] & (x.col("l_shipdate") > days("1995-03-15"))
    inv, (key,) = x.group(x.col("l_orderkey")[m])
    rev = (x.dec("l_extendedprice") * x.dec("l_discount").one_minus())[m].sum(inv, len(key))
    o, _ = x.lookup("o_orderkey", key)
    return [key, rev, x.col("o_orderdate")[o], x.col("o_shippriority")[o]]
