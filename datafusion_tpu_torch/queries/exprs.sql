select
    extract(year from l_shipdate) as l_year,
    sum(case
        when l_returnflag = 'R' then l_extendedprice * (1 - l_discount)
        else 0
    end) as returned_revenue,
    count(*) as lines
from
    lineitem
where
    l_linenumber in (1, 2, 3)
group by
    extract(year from l_shipdate)
order by
    l_year;
