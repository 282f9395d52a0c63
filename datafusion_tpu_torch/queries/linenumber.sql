select
    l_linenumber,
    count(*) as count_lines,
    sum(l_quantity) as sum_qty,
    avg(l_extendedprice) as avg_price,
    min(l_shipdate) as first_ship,
    max(l_discount) as max_disc
from
    lineitem
group by
    l_linenumber
order by
    l_linenumber;
