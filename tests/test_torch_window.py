"""Windows in the torch port (ops/window.py) on the CPU.

  (The twins of tests/test_window_frames.py, its 21 frames against sqlite,
  are in test_torch_window_frames.py.)
  * Random inputs made from a numpy seed, the JAX package against the port
    on identical buffers (``torch_parity.port_table``): partitions of one
    row and of hundreds, NULL partition keys, an IN filter that empties
    whole partitions, NULL, NaN, -0.0 and 0.0 values, duplicate and NULL
    order keys, int64 values next to wrap-around; every window function and
    ROWS, RANGE and GROUPS frames.  Rows are compared exactly, in order,
    floats included (NaN equal to NaN, -0.0 told from 0.0): the port adds
    float frames in the reference's associative-scan order and bisects
    frames with the reference's steps.
  * A window in a fused stage and a window run as its own operator give the
    same rows; a warm window plan runs as one unit (no host read).
  * Reference fault F11: the JAX package leaves rows at 0.0 out of a RANGE
    frame over a float key whose upper bound is exactly 0.0; the port gives
    sqlite's rows.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import math
import sqlite3

import numpy as np
import pytest

import datafusion_tpu as J
from datafusion_tpu.columnar.table import Table as JTable

import datafusion_tpu_torch as D
from datafusion_tpu_torch.columnar.table import HOST_SYNCS
from datafusion_tpu_torch.ops.window import WindowAggExec

from torch_parity import port_table


@pytest.fixture(scope="module")
def contexts():
    rng = np.random.default_rng(11)
    sizes = [1, 1, 2, 3, 5, 8, 40, 100, 240, 300]
    n = sum(sizes)
    part = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(part)
    g = [None if rng.random() < 0.05 else f"p{x:02d}" for x in part]
    k = [None if rng.random() < 0.08 else int(x) for x in rng.integers(-20, 20, n)]
    special = rng.random(n)
    vals = rng.integers(-40, 40, n) / 8.0
    v = [None if s < 0.05 else float("nan") if s < 0.1 else -0.0 if s < 0.15 else 0.0 if s < 0.2
         else float(x) for s, x in zip(special, vals)]
    w = [int(x) for x in rng.choice([2**62, -(2**62), 2**62 - 1, 3 * 2**61, (1 << 63) - 3,
                                      -(1 << 63) + 2, 5, -7], n)]
    jt = JTable.from_pydict({"g": g, "k": k, "v": v, "w": w, "r": list(range(n))})
    jctx = J.ExecutionContext()
    jctx.register_table("t", jt)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_table("t", port_table(jt))
    return jctx, pctx


WINDOWS = [
    "row_number() OVER (PARTITION BY g ORDER BY k, r)",
    "rank() OVER (PARTITION BY g ORDER BY k)",
    "dense_rank() OVER (PARTITION BY g ORDER BY v)",
    "percent_rank() OVER (PARTITION BY g ORDER BY k)",
    "cume_dist() OVER (PARTITION BY g ORDER BY k DESC)",
    "ntile(3) OVER (PARTITION BY g ORDER BY r)",
    "lag(v, 2) OVER (PARTITION BY g ORDER BY r)",
    "lead(w) OVER (PARTITION BY g ORDER BY r)",
    "first_value(v) OVER (PARTITION BY g ORDER BY r)",
    "last_value(k) OVER (PARTITION BY g ORDER BY r)",
    "nth_value(v, 3) OVER (PARTITION BY g ORDER BY r)",
    "sum(v) OVER (PARTITION BY g ORDER BY r)",
    "sum(w) OVER (PARTITION BY g ORDER BY r ROWS BETWEEN 3 PRECEDING AND 2 FOLLOWING)",
    "avg(v) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN 2 PRECEDING AND 1 FOLLOWING)",
    "min(v) OVER (PARTITION BY g ORDER BY r ROWS BETWEEN 5 PRECEDING AND 5 FOLLOWING)",
    "max(v) OVER (PARTITION BY g ORDER BY k GROUPS BETWEEN 1 PRECEDING AND 1 FOLLOWING)",
    "min(w) OVER (PARTITION BY g)",
    "max(k) OVER (PARTITION BY g ORDER BY r ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)",
    "sum(w) OVER (ORDER BY w RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING)",
    "sum(v) OVER (PARTITION BY g ORDER BY k DESC RANGE BETWEEN 1 PRECEDING AND CURRENT ROW)",
    "count(*) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 2 FOLLOWING AND 4 FOLLOWING)",
    "min(v) OVER (PARTITION BY g ORDER BY k)",
    "max(v) OVER (PARTITION BY g ORDER BY r ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING)",
]


def _same(x, y) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(y, float):
        if math.isnan(y):
            return isinstance(x, float) and math.isnan(x)
        return x == y and math.copysign(1.0, x) == math.copysign(1.0, y)
    return x == y


def _assert_rows_exact(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    rows_g, rows_w = list(zip(*got.values())), list(zip(*want.values()))
    assert len(rows_g) == len(rows_w)
    for i, (a, b) in enumerate(zip(rows_g, rows_w)):
        assert all(_same(x, y) for x, y in zip(a, b)), (i, a, b)


# every other window over a filter that empties two whole partitions (the
# stage compacts before the window), the rest over every row
WHERES = ["", " WHERE g NOT IN ('p09', 'p00')"]


@pytest.mark.parametrize("window,where", [(w, WHERES[i % 2]) for i, w in enumerate(WINDOWS)])
def test_random_windows_match_jax(contexts, window, where):
    jctx, pctx = contexts
    sql = f"SELECT g, k, v, w, r, {window} AS x FROM t{where}"
    want = jctx.sql(sql).collect().to_pydict()
    for _ in range(3):  # the cold run, the check and a warm run
        _assert_rows_exact(pctx.sql(sql).collect().to_pydict(), want)


def test_fused_and_unfused_windows_agree(contexts):
    """The stage compiler's window branch (the default) and WindowAggExec on
    its own (no physical rules) give the same rows."""
    _, pctx = contexts
    sql = ("SELECT g, r, sum(w) OVER (PARTITION BY g ORDER BY r ROWS BETWEEN 1 PRECEDING AND "
           "1 FOLLOWING) AS s, rank() OVER (PARTITION BY g ORDER BY r) AS rk FROM t WHERE k > 0")
    fused = pctx.sql(sql).collect().to_pydict()
    plain = D.ExecutionContext(D.ExecutionConfig(), device="cpu")
    plain.config.physical_optimizer_rules = [_NoRule()]
    plain.register_table("t", pctx.table("t").collect())
    phys = plain.create_physical_plan(plain.optimize(plain.create_logical_plan(sql)))
    assert _has(phys, WindowAggExec)
    _assert_rows_exact(plain.sql(sql).collect().to_pydict(), fused)


class _NoRule:
    name = "none"

    def optimize(self, plan):
        return plan


def _has(plan, cls) -> bool:
    return isinstance(plan, cls) or any(_has(c, cls) for c in plan.children())


def test_warm_window_plan_is_one_unit(contexts):
    """The window reads nothing on the host: the plan becomes one unit on
    its second collect and a warm collect reads the host once at most (the
    stage's learned-capacity flag)."""
    _, pctx = contexts
    sql = "SELECT g, rank() OVER (PARTITION BY g ORDER BY k DESC) AS rk FROM t WHERE r > 10"
    for _ in range(3):
        s0 = HOST_SYNCS[0]
        pctx.sql(sql).collect()
        syncs = HOST_SYNCS[0] - s0
    wq = pctx._plan_cache[list(pctx._plan_cache)[-1]]._whole_query
    assert wq.is_program, wq.failure
    assert syncs <= 1


def test_range_frame_with_a_zero_upper_bound_f11():
    """Reference fault F11: RANGE BETWEEN 1.5 PRECEDING AND 0.5 FOLLOWING
    over v = -0.5 ends at exactly 0.0.  The frame's end is the first key
    above 0.0, found as a bisection for the next double up; XLA on the CPU
    flushes that subnormal to 0.0, so the JAX package leaves the rows at
    0.0 and -0.0 out.  The port keeps them, as sqlite does."""
    data = {"v": [-0.5, 0.0, -0.0, 1.0, -2.0]}
    sql = ("SELECT v, count(v) OVER (ORDER BY v RANGE BETWEEN 1.5 PRECEDING AND 0.5 FOLLOWING) AS c "
           "FROM t")
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE t (v REAL)")
    conn.executemany("INSERT INTO t VALUES (?)", [(x,) for x in data["v"]])
    oracle = sorted(conn.execute(sql).fetchall())
    jt = JTable.from_pydict(data)
    jctx = J.ExecutionContext()
    jctx.register_table("t", jt)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_table("t", port_table(jt))
    got = pctx.sql(sql).collect().to_pydict()
    want = jctx.sql(sql).collect().to_pydict()
    assert sorted(zip(got["v"], got["c"])) == oracle
    # frame [-2.0, 0.0] of v = -0.5: sqlite and the port count -2.0, -0.5,
    # 0.0 and -0.0; the JAX package only the first two
    assert dict(oracle)[-0.5] == 4
    assert dict(zip(want["v"], want["c"]))[-0.5] == 2
