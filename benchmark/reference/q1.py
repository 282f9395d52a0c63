"""TPC-H Q1, the pricing summary report."""

from ..tpchgen import days

COLUMNS = [("l_returnflag", "str"), ("l_linestatus", "str"), ("sum_qty", "decimal:2"),
           ("sum_base_price", "decimal:2"), ("sum_disc_price", "decimal:4"),
           ("sum_charge", "decimal:6"), ("avg_qty", "float"), ("avg_price", "float"),
           ("avg_disc", "float"), ("count_order", "int")]
ORDER_BY = [(0, False), (1, False)]
LIMIT = None


def run(x):
    m = x.col("l_shipdate") <= days("1998-09-02")
    inv, (rf, ls) = x.group(x.col("l_returnflag")[m], x.col("l_linestatus")[m])
    g = len(rf)
    qty, price = x.dec("l_quantity")[m], x.dec("l_extendedprice")[m]
    disc, tax = x.dec("l_discount")[m], x.dec("l_tax")[m]
    disc_price = price * disc.one_minus()
    n = x.counts(inv, g)
    return [x.strings("l_returnflag", rf), x.strings("l_linestatus", ls), qty.sum(inv, g),
            price.sum(inv, g), disc_price.sum(inv, g), (disc_price * tax.one_plus()).sum(inv, g),
            qty.mean(inv, g, n), price.mean(inv, g, n), disc.mean(inv, g, n), n]
