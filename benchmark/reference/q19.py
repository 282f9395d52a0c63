"""TPC-H Q19, the discounted revenue query: the OR of three ANDs, each
over part and line columns (``'AIR REG'`` is no ship mode of the data, as
in the specification)."""

COLUMNS = [("revenue", "decimal:4")]
ORDER_BY = []
LIMIT = None
BRANCHES = (("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 15))


def run(x):
    part, phit = x.lookup("p_partkey", x.col("l_partkey"))
    brand, cont, size = (x.col(c)[part] for c in ("p_brand", "p_container", "p_size"))
    qty = x.col("l_quantity")  # cents
    common = (phit & x.isin("l_shipmode", x.col("l_shipmode"), ["AIR", "AIR REG"])
              & (x.col("l_shipinstruct") == x.code("l_shipinstruct", "DELIVER IN PERSON")))
    m = None
    for b, containers, q, top in BRANCHES:
        one = ((brand == x.code("p_brand", b)) & x.isin("p_container", cont, containers)
               & (qty >= 100 * q) & (qty <= 100 * (q + 10)) & (size >= 1) & (size <= top))
        m = one if m is None else m | one
    m = m & common
    return [(x.dec("l_extendedprice") * x.dec("l_discount").one_minus())[m].total()]
