"""TPC-H Q9, the product type profit measure query."""

COLUMNS = [("nation", "str"), ("o_year", "int"), ("sum_profit", "decimal:4")]
ORDER_BY = [(0, False), (1, True)]
LIMIT = None


def run(x):
    green = x.where("p_name", lambda s: "green" in s)
    part, phit = x.lookup("p_partkey", x.col("l_partkey"))
    width = int(x.col("ps_suppkey").max()) + 1
    ps, pshit = x.lookup("partsupp", x.col("l_partkey") * width + x.col("l_suppkey"),
                         keys=x.col("ps_partkey") * width + x.col("ps_suppkey"))
    supp, shit = x.lookup("s_suppkey", x.col("l_suppkey"))
    nat, nhit = x.lookup("n_nationkey", x.col("s_nationkey")[supp])
    order, ohit = x.lookup("o_orderkey", x.col("l_orderkey"))
    m = phit & green[x.col("p_name")[part].long()] & pshit & shit & nhit & ohit
    inv, (nation, year) = x.group(x.col("n_name")[nat[m]], x.year(x.col("o_orderdate")[order[m]]))
    amount = (x.dec("l_extendedprice") * x.dec("l_discount").one_minus()
              - x.dec("ps_supplycost")[ps] * x.dec("l_quantity"))
    return [x.strings("n_name", nation), year, amount[m].sum(inv, len(nation))]
