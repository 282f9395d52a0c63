select
    l_linenumber,
    count(distinct l_suppkey) as suppliers
from
    lineitem
group by
    l_linenumber;
