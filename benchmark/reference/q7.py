"""TPC-H Q7, the volume shipping query."""

from ..tpchgen import days

COLUMNS = [("supp_nation", "str"), ("cust_nation", "str"), ("l_year", "int"),
           ("revenue", "decimal:4")]
ORDER_BY = [(0, False), (1, False), (2, False)]
LIMIT = None


def run(x):
    fr, de = x.code("n_name", "FRANCE"), x.code("n_name", "GERMANY")
    d = x.col("l_shipdate")
    supp, shit = x.lookup("s_suppkey", x.col("l_suppkey"))
    n1, h1 = x.lookup("n_nationkey", x.col("s_nationkey")[supp])
    order, ohit = x.lookup("o_orderkey", x.col("l_orderkey"))
    cust, chit = x.lookup("c_custkey", x.col("o_custkey")[order])
    n2, h2 = x.lookup("n_nationkey", x.col("c_nationkey")[cust])
    a, b = x.col("n_name")[n1], x.col("n_name")[n2]
    m = (shit & h1 & ohit & chit & h2 & (d >= days("1995-01-01")) & (d <= days("1996-12-31"))
         & (((a == fr) & (b == de)) | ((a == de) & (b == fr))))
    inv, (sn, cn, year) = x.group(a[m], b[m], x.year(d[m]))
    rev = (x.dec("l_extendedprice") * x.dec("l_discount").one_minus())[m].sum(inv, len(sn))
    return [x.strings("n_name", sn), x.strings("n_name", cn), year, rev]
