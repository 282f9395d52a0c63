select
    l_orderkey,
    sum(l_quantity) as sum_qty
from
    lineitem
group by
    l_orderkey
having
    sum(l_quantity) > 300;
