"""TPC-H Q17, the small-quantity-order revenue query.

The correlated subquery is computed directly: each selected part's
quantity sum and line count over all its lines; a line qualifies when
``l_quantity < 0.2 * avg``, compared exactly (5 * quantity * count < sum,
in cents); float32 in the control.  ``sum(l_extendedprice) / 7.0`` in
float64, the port's type for a decimal divided by a float.
"""

COLUMNS = [("avg_yearly", "float")]
ORDER_BY = []
LIMIT = None


def run(x):
    part, phit = x.lookup("p_partkey", x.col("l_partkey"))
    sel = (phit & (x.col("p_brand")[part] == x.code("p_brand", "Brand#23"))
           & (x.col("p_container")[part] == x.code("p_container", "MED BOX")))
    inv, (key,) = x.group(x.col("l_partkey")[sel])
    qty = x.dec("l_quantity")[sel]
    total, n = qty.sum(inv, len(key)).v, x.counts(inv, len(key))
    if qty.exact:
        small = 5 * qty.v * n[inv] < total[inv]
    else:
        small = qty.v < 0.2 * (total / n.to(total.dtype))[inv]
    price = x.dec("l_extendedprice")[sel][small].total().v
    if qty.exact:
        return [price.double() / 100 / 7.0]
    return [price / 7.0]
