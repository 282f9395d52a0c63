"""TPC-H Q8, the national market share query.

The share is the ratio of two exact decimal sums, taken in float64 (the
port's type for a decimal divided by a decimal); float32 in the control.
"""

from ..tpchgen import days

COLUMNS = [("o_year", "int"), ("mkt_share", "float")]
ORDER_BY = [(0, False)]
LIMIT = None


def run(x):
    part, phit = x.lookup("p_partkey", x.col("l_partkey"))
    supp, shit = x.lookup("s_suppkey", x.col("l_suppkey"))
    n2, h2 = x.lookup("n_nationkey", x.col("s_nationkey")[supp])
    order, ohit = x.lookup("o_orderkey", x.col("l_orderkey"))
    cust, chit = x.lookup("c_custkey", x.col("o_custkey")[order])
    n1, h1 = x.lookup("n_nationkey", x.col("c_nationkey")[cust])
    reg, rhit = x.lookup("r_regionkey", x.col("n_regionkey")[n1])
    d = x.col("o_orderdate")[order]
    m = (phit & (x.col("p_type")[part] == x.code("p_type", "ECONOMY ANODIZED STEEL")) & shit & h2
         & ohit & chit & h1 & rhit & (x.col("r_name")[reg] == x.code("r_name", "AMERICA"))
         & (d >= days("1995-01-01")) & (d <= days("1996-12-31")))
    inv, (year,) = x.group(x.year(d[m]))
    g = len(year)
    volume = (x.dec("l_extendedprice") * x.dec("l_discount").one_minus())[m]
    brazil = x.col("n_name")[n2[m]] == x.code("n_name", "BRAZIL")
    total = volume.sum(inv, g).v
    part_of = volume[brazil].sum(inv[brazil], g).v
    if volume.exact:
        return [year, part_of.double() / total.double()]
    return [year, part_of / total]
