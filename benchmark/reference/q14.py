"""TPC-H Q14, the promotion effect query.

``100.00 * sum(promo) / sum(all)``: two exact decimal sums, the ratio in
float64 (the port's type for a decimal divided by a decimal); float32 in
the control.
"""

from ..tpchgen import days

COLUMNS = [("promo_revenue", "float")]
ORDER_BY = []
LIMIT = None


def run(x):
    part, phit = x.lookup("p_partkey", x.col("l_partkey"))
    d = x.col("l_shipdate")
    m = phit & (d >= days("1995-09-01")) & (d < days("1995-10-01"))
    promo = x.where("p_type", lambda s: s.startswith("PROMO"))[x.col("p_type")[part[m]].long()]
    revenue = (x.dec("l_extendedprice") * x.dec("l_discount").one_minus())[m]
    total, part_of = revenue.total().v, revenue[promo].total().v
    if revenue.exact:
        return [100.0 * part_of.double() / total.double()]
    return [100.0 * part_of / total]
