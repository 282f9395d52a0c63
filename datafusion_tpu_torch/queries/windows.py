"""The window and rolling-window queries: the window shapes of TPC-DS
(Q67/Q70, Q51, Q47/Q57, Q12/Q98) and CubeStore's rolling window over the
TPC-H tables of ``tpchdata``.

Each query has a full form (every row) and a timed form, the full form
under the ORDER BY ... LIMIT 100 that TPC-DS puts around it (W1 with
Q67/Q70's filter on the rank, W3 with Q47/Q57's on the neighbours); R1's
result is small and has one form.
``window_sql(name, timed)`` gives the text.
"""

# name -> (full form, what the timed form puts around it, the columns that
# identify a row of the full form)
_W_LINEITEM_ORDER = "ORDER BY l_shipdate, l_orderkey, l_linenumber"
WINDOW_QUERIES = {
    # W1, TPC-DS Q67/Q70: rank within a partition
    "W1": ("SELECT o_custkey, o_orderkey, o_totalprice, "
           "rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC) AS rk, "
           "dense_rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC) AS drk FROM orders",
           "WHERE rk <= 3 ORDER BY o_custkey, rk, o_orderkey LIMIT 100", ("o_orderkey",)),
    # W2, TPC-DS Q51: a running sum
    "W2": ("SELECT l_suppkey, l_orderkey, l_linenumber, l_shipdate, sum(l_extendedprice) OVER "
           f"(PARTITION BY l_suppkey {_W_LINEITEM_ORDER} ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT "
           "ROW) AS cume FROM lineitem",
           "ORDER BY l_suppkey, l_shipdate, l_orderkey, l_linenumber LIMIT 100",
           ("l_orderkey", "l_linenumber")),
    # W3, TPC-DS Q47/Q57: a moving frame, lag and lead; the timed form
    # keeps the rows that have both neighbours, as Q47/Q57 do by joining
    # each row to the rows ranked one before and one after it
    "W3": ("SELECT l_partkey, l_orderkey, l_linenumber, "
           + ", ".join(f"{f}(l_quantity) OVER (PARTITION BY l_partkey {_W_LINEITEM_ORDER} ROWS BETWEEN "
                       f"3 PRECEDING AND 3 FOLLOWING) AS {f}_q" for f in ("avg", "min", "max"))
           + f", lag(l_extendedprice) OVER (PARTITION BY l_partkey {_W_LINEITEM_ORDER}) AS prev_p, "
           f"lead(l_extendedprice) OVER (PARTITION BY l_partkey {_W_LINEITEM_ORDER}) AS next_p "
           "FROM lineitem",
           "WHERE prev_p IS NOT NULL AND next_p IS NOT NULL ORDER BY l_partkey, l_orderkey, l_linenumber "
           "LIMIT 100", ("l_orderkey", "l_linenumber")),
    # W4: TPC-DS Q12/Q98's ratio to a partition total over an aggregate
    # does not plan in the JAX package (a window over an aggregate's
    # output), so a RANGE offset frame on an integer column: a customer's
    # spend over the 90 days up to each order
    "W4": ("SELECT o_custkey, o_orderkey, d, o_totalprice, sum(o_totalprice) OVER (PARTITION BY "
           "o_custkey ORDER BY d RANGE BETWEEN 90 PRECEDING AND CURRENT ROW) AS spend90 FROM "
           "(SELECT o_custkey, o_orderkey, CAST(o_orderdate AS BIGINT) AS d, o_totalprice FROM orders) o",
           "ORDER BY o_custkey, d, o_orderkey LIMIT 100", ("o_orderkey",)),
    # R1, Cube's rollingWindow { trailing: '7 day' }: a 7-day trailing sum
    # per ship mode over every day of l_shipdate (2,526 days)
    "R1": ("SELECT l_shipmode, day, ROLLING(SUM(l_extendedprice) RANGE 6 PRECEDING) AS s7 FROM "
           "(SELECT l_shipmode, CAST(l_shipdate AS BIGINT) AS day, l_extendedprice FROM lineitem) li "
           "ROLLING_WINDOW(DIMENSION day, PARTITION BY l_shipmode, FROM 8036 TO 10561 EVERY 1)",
           None, ("l_shipmode", "day")),
}


def window_sql(name: str, timed: bool) -> str:
    """The text of window query ``name``: its timed form or its full form."""
    full, tail, _ = WINDOW_QUERIES[name]
    if not timed or tail is None:
        return full
    return f"SELECT * FROM ({full}) w {tail}"
