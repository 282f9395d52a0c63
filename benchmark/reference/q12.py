"""TPC-H Q12, the shipping modes and order priority query."""

from ..tpchgen import days

COLUMNS = [("l_shipmode", "str"), ("high_line_count", "int"), ("low_line_count", "int")]
ORDER_BY = [(0, False)]
LIMIT = None


def run(x):
    mode, ship = x.col("l_shipmode"), x.col("l_shipdate")
    commit, receipt = x.col("l_commitdate"), x.col("l_receiptdate")
    order, hit = x.lookup("o_orderkey", x.col("l_orderkey"))
    m = (hit & x.isin("l_shipmode", mode, ["MAIL", "SHIP"]) & (commit < receipt) & (ship < commit)
         & (receipt >= days("1994-01-01")) & (receipt < days("1995-01-01")))
    inv, (key,) = x.group(mode[m])
    high = x.isin("o_orderpriority", x.col("o_orderpriority")[order[m]], ["1-URGENT", "2-HIGH"]).long()
    n = x.counts(inv, len(key))
    high_n = n.new_zeros(len(key)).index_add_(0, inv, high)
    return [x.strings("l_shipmode", key), high_n, n - high_n]
