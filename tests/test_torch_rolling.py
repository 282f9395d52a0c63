"""ROLLING_WINDOW in the torch port (ops/rolling.py) against the JAX
package on the CPU, on identical random buffers made from a numpy seed:
NULL partition keys, dimensions and values, days outside the grid, a
partition of one row and one whose rows all lie outside the grid, int64
values next to wrap-around, grids that start before and end after the
data, EVERY 2 and 3, windows before and after each grid point, GROUP BY
DIMENSION.  Keys, counts, integer sums, min and max are exact; float sums
and averages rel 1e-12 (the engines add in other orders).  Also: a warm
ROLLING_WINDOW plan is one unit (the partition count it read first is
learned)."""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

import datafusion_tpu as J
from datafusion_tpu.columnar.table import Table as JTable

import datafusion_tpu_torch as D
from datafusion_tpu_torch.columnar.table import HOST_SYNCS

from torch_parity import assert_rows_equal, port_table


@pytest.fixture(scope="module")
def contexts():
    rng = np.random.default_rng(5)
    n = 500
    site = [None if rng.random() < 0.05 else f"s{x}" for x in rng.integers(0, 7, n)]
    day = [None if rng.random() < 0.03 else int(x) for x in rng.integers(-3, 40, n)]
    site[7] = "one-row"  # a partition of one row
    for i in (11, 12, 13):  # a partition whose rows all fall outside every grid
        site[i], day[i] = "off-grid", 60 + i
    jt = JTable.from_pydict({
        "site": site,
        "day": day,
        "hits": [None if rng.random() < 0.1 else int(x) for x in rng.integers(-1000, 1000, n)],
        "big": [int(x) for x in rng.choice([2**62, -(2**62), (1 << 63) - 3, 7], n)],
        "f": [None if s < 0.05 else float(x) for s, x in zip(rng.random(n), rng.integers(-80, 80, n) / 4)],
    })
    jctx = J.ExecutionContext()
    jctx.register_table("e", jt)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_table("e", port_table(jt))
    return jctx, pctx


QUERIES = [
    "SELECT site, day, ROLLING(SUM(hits)) AS s, ROLLING(COUNT(hits)) AS c, ROLLING(MIN(hits)) AS mn, "
    "ROLLING(MAX(f)) AS mx FROM e ROLLING_WINDOW(DIMENSION day, PARTITION BY site, FROM 0 TO 35 EVERY 1)",
    "SELECT site, day, ROLLING(SUM(big) RANGE 2 PRECEDING) AS s, ROLLING(AVG(f) RANGE 3 PRECEDING) AS a, "
    "ROLLING(COUNT(*) RANGE 1 PRECEDING) AS c FROM e "
    "ROLLING_WINDOW(DIMENSION day, PARTITION BY site, FROM 2 TO 38 EVERY 1)",
    "SELECT day, ROLLING(SUM(hits) RANGE 4 PRECEDING) AS s, ROLLING(SUM(f) RANGE BETWEEN 2 PRECEDING AND "
    "2 FOLLOWING) AS sf FROM e ROLLING_WINDOW(DIMENSION day, FROM -5 TO 45 EVERY 2)",
    "SELECT day, ROLLING(SUM(hits)) AS run, SUM(hits) AS per, COUNT(f) AS cf, AVG(f) AS af FROM e "
    "ROLLING_WINDOW(DIMENSION day, FROM 1 TO 30 EVERY 3, GROUP BY DIMENSION day)",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_random_rolling_windows_match_jax(contexts, sql):
    jctx, pctx = contexts
    want = jctx.sql(sql).collect().to_pydict()
    floats = {k for k, v in want.items() if any(isinstance(x, float) for x in v)}
    for _ in range(3):
        assert_rows_equal(pctx.sql(sql).collect().to_pydict(), want, floats)


def test_warm_rolling_plan_is_one_unit(contexts):
    _, pctx = contexts
    sql = QUERIES[0]
    for _ in range(3):
        s0 = HOST_SYNCS[0]
        pctx.sql(sql).collect()
        syncs = HOST_SYNCS[0] - s0
    wq = pctx._plan_cache[list(pctx._plan_cache)[-1]]._whole_query
    assert wq.is_program, wq.failure
    assert syncs == 1  # the flags' sum
