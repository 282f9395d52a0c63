"""TPC-H Q18, the large volume customer query (no LIMIT)."""

COLUMNS = [("c_name", "str"), ("c_custkey", "int"), ("o_orderkey", "int"), ("o_orderdate", "date"),
           ("o_totalprice", "decimal:2"), ("SUM(lineitem.l_quantity)", "decimal:2")]
ORDER_BY = [(4, True), (3, False)]
LIMIT = None


def run(x):
    inv, (key,) = x.group(x.col("l_orderkey"))
    qty = x.dec("l_quantity").sum(inv, len(key))
    big = qty.v > x.lit(300, 2)
    order, ohit = x.lookup("o_orderkey", key[big])
    cust, chit = x.lookup("c_custkey", x.col("o_custkey")[order])
    m = ohit & chit
    order, cust = order[m], cust[m]
    return [x.strings("c_name", x.col("c_name")[cust]), x.col("c_custkey")[cust],
            x.col("o_orderkey")[order], x.col("o_orderdate")[order], x.dec("o_totalprice")[order],
            qty[big][m]]
