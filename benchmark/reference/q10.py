"""TPC-H Q10, the returned item reporting query (no LIMIT)."""

from ..tpchgen import days

COLUMNS = [("c_custkey", "int"), ("c_name", "str"), ("revenue", "decimal:4"),
           ("c_acctbal", "decimal:2"), ("n_name", "str"), ("c_address", "str"), ("c_phone", "str"),
           ("c_comment", "str")]
ORDER_BY = [(2, True)]
LIMIT = None


def run(x):
    d = x.col("o_orderdate")
    orders = (d >= days("1993-10-01")) & (d < days("1994-01-01"))
    order, ohit = x.lookup("o_orderkey", x.col("l_orderkey"))
    m = ohit & orders[order] & (x.col("l_returnflag") == x.code("l_returnflag", "R"))
    inv, (key,) = x.group(x.col("o_custkey")[order[m]])
    rev = (x.dec("l_extendedprice") * x.dec("l_discount").one_minus())[m].sum(inv, len(key))
    cust, _ = x.lookup("c_custkey", key)
    nat, _ = x.lookup("n_nationkey", x.col("c_nationkey")[cust])
    return [key, x.strings("c_name", x.col("c_name")[cust]), rev, x.dec("c_acctbal")[cust],
            x.strings("n_name", x.col("n_name")[nat]), x.strings("c_address", x.col("c_address")[cust]),
            x.strings("c_phone", x.col("c_phone")[cust]), x.strings("c_comment", x.col("c_comment")[cust])]
