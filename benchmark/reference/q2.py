"""TPC-H Q2, the minimum cost supplier query, with the specification's
row limit (100).

The correlated subquery is computed directly: each part's least supply
cost over its European suppliers, then the European offers of the
selected parts (size 15, type ``%BRASS``) at that cost.
"""

COLUMNS = [("s_acctbal", "decimal:2"), ("s_name", "str"), ("n_name", "str"), ("p_partkey", "int"),
           ("p_mfgr", "str"), ("s_address", "str"), ("s_phone", "str"), ("s_comment", "str")]
ORDER_BY = [(0, True), (2, False), (1, False), (3, False)]
LIMIT = 100


def run(x):
    nat, nhit = x.lookup("n_nationkey", x.col("s_nationkey"))
    reg, rhit = x.lookup("r_regionkey", x.col("n_regionkey")[nat])
    europe = nhit & rhit & (x.col("r_name")[reg] == x.code("r_name", "EUROPE"))
    supp, shit = x.lookup("s_suppkey", x.col("ps_suppkey"))
    offer = shit & europe[supp]
    cost = x.dec("ps_supplycost")
    inv, (key,) = x.group(x.col("ps_partkey")[offer])
    least = cost.v.new_zeros(len(key)).scatter_reduce_(0, inv, cost.v[offer], "amin", include_self=False)
    part, phit = x.lookup("p_partkey", x.col("ps_partkey")[offer])
    brass = x.where("p_type", lambda s: s.endswith("BRASS"))
    m = (phit & (x.col("p_size")[part] == 15) & brass[x.col("p_type")[part].long()]
         & (cost.v[offer] == least[inv]))
    s, p = supp[offer][m], part[m]
    n = nat[s]
    return [x.dec("s_acctbal")[s], x.strings("s_name", x.col("s_name")[s]),
            x.strings("n_name", x.col("n_name")[n]), x.col("p_partkey")[p],
            x.strings("p_mfgr", x.col("p_mfgr")[p]), x.strings("s_address", x.col("s_address")[s]),
            x.strings("s_phone", x.col("s_phone")[s]), x.strings("s_comment", x.col("s_comment")[s])]
