"""TPC-H Q11, the important stock identification query, with FRACTION
0.0001 at every scale, as upstream DataFusion's ``q11.sql`` has it.

The HAVING's scalar subquery is computed directly: the total value of
Germany's stock.  A part qualifies when its value exceeds the total times
0.0001, compared exactly (value * 10^4 > total in cents).
"""

from . import Dec

COLUMNS = [("ps_partkey", "int"), ("value", "decimal:2")]
ORDER_BY = [(1, True)]
LIMIT = None


def run(x):
    supp, shit = x.lookup("s_suppkey", x.col("ps_suppkey"))
    nat, nhit = x.lookup("n_nationkey", x.col("s_nationkey")[supp])
    m = shit & nhit & (x.col("n_name")[nat] == x.code("n_name", "GERMANY"))
    cost = x.dec("ps_supplycost")
    stock = Dec(cost.v * x.col("ps_availqty").to(cost.v.dtype), cost.scale, cost.exact)[m]
    inv, (key,) = x.group(x.col("ps_partkey")[m])
    value = stock.sum(inv, len(key))
    total = stock.total().v
    keep = value.v * 10_000 > total if value.exact else value.v > total * 0.0001
    return [key[keep], value[keep]]
