"""TPC-H Q5, the local supplier volume query."""

import torch

from ..tpchgen import days

COLUMNS = [("n_name", "str"), ("revenue", "decimal:4")]
ORDER_BY = [(1, True)]
LIMIT = None


def run(x):
    asia = x.col("r_regionkey")[x.col("r_name") == x.code("r_name", "ASIA")]
    in_asia = torch.isin(x.col("n_regionkey"), asia)
    d = x.col("o_orderdate")
    orders = (d >= days("1994-01-01")) & (d < days("1995-01-01"))
    order, ohit = x.lookup("o_orderkey", x.col("l_orderkey"))
    cust, chit = x.lookup("c_custkey", x.col("o_custkey")[order])
    supp, shit = x.lookup("s_suppkey", x.col("l_suppkey"))
    nation = x.col("s_nationkey")[supp]
    nat, nhit = x.lookup("n_nationkey", nation)
    m = ohit & orders[order] & chit & shit & nhit & (x.col("c_nationkey")[cust] == nation) & in_asia[nat]
    inv, (name,) = x.group(x.col("n_name")[nat[m]])
    rev = (x.dec("l_extendedprice") * x.dec("l_discount").one_minus())[m].sum(inv, len(name))
    return [x.strings("n_name", name), rev]

