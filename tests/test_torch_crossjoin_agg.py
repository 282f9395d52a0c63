"""CrossJoinAggExec in the torch port (ops/joinagg.py) against the JAX
package on the CPU, on identical buffers made from a numpy seed.

  * One tile and many (``TILE_ROWS`` cut), either side kept whole: every
    aggregate's rows equal the JAX package's (keys, counts, integer sums,
    min and max exact; float sums and averages rel 1e-12: the port merges
    its tiles' partial states in another order).
  * Reference fault F10: with more than one tile the JAX package sums the
    tiles' COUNT(DISTINCT) values, so a value seen in two tiles counts
    twice; the port concatenates the tiles' surviving pairs and counts once,
    giving the one-tile rows.
  * Reference fault F12: min/max over a string column loses its
    dictionary in the JAX package's CrossJoinAggExec (the partial state
    carries none into the merge), and decoding the result fails; the port
    gives a pandas oracle's rows.
  * The plan survives a rebuild (``with_new_children``; the reference's test
    round-trips it through the distributed serde, not ported yet).
  * A warm CrossJoinAgg plan is one unit: the tiling and the tile counts
    that the first run read are kept, and later runs read nothing on the
    host but the flags' sum.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

import datafusion_tpu as J
import datafusion_tpu.ops.joinagg as JJA
from datafusion_tpu.columnar.table import Table as JTable

import datafusion_tpu_torch as D
import datafusion_tpu_torch.ops.joinagg as PJA
from datafusion_tpu_torch.columnar.table import HOST_SYNCS

from torch_parity import assert_rows_equal, port_table


def _contexts():
    rng = np.random.default_rng(17)
    a = JTable.from_pydict({
        "g": [None if z else int(v) for z, v in zip(rng.random(300) < 0.05, rng.integers(0, 5, 300))],
        "x": rng.integers(0, 40, 300),
        "q": [None if z else float(v) for z, v in zip(rng.random(300) < 0.1, rng.integers(-50, 50, 300) / 4)],
    })
    b = JTable.from_pydict({"y": rng.integers(0, 40, 80), "w": rng.random(80),
                            "s": list(rng.choice(["ab", "cd", "ef", "gh"], 80))})
    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    for name, t in (("a", a), ("b", b)):
        jctx.register_table(name, t)
        pctx.register_table(name, port_table(t))
    return jctx, pctx


QUERIES = [
    "SELECT a.g, count(*) c, sum(b.w) s, min(b.y) mn, avg(a.q) aq, sum(a.x) sx "
    "FROM a, b WHERE a.x < b.y GROUP BY a.g ORDER BY a.g",
    "SELECT b.s, count(a.q) c, min(a.q) mq, max(a.q) xq, stddev(a.x) sd FROM a, b "
    "WHERE a.x + 3 > b.y GROUP BY b.s ORDER BY b.s",
    "SELECT count(*) c, sum(a.x) sx, max(b.w) mw FROM a, b",
    "SELECT a.g, b.s, count(*) c FROM a, b WHERE a.x = b.y OR a.q > 10 GROUP BY a.g, b.s "
    "ORDER BY a.g, b.s",
]


@pytest.mark.parametrize("tile_rows", [1 << 22, 1 << 9])
@pytest.mark.parametrize("sql", QUERIES)
def test_tiles_match_jax(sql, tile_rows, monkeypatch):
    monkeypatch.setattr(JJA, "TILE_ROWS", tile_rows)
    monkeypatch.setattr(PJA, "TILE_ROWS", tile_rows)
    jctx, pctx = _contexts()
    want = jctx.sql(sql).collect().to_pydict()
    floats = {k for k, v in want.items() if any(isinstance(x, float) for x in v)}
    for _ in range(3):
        assert_rows_equal(pctx.sql(sql).collect().to_pydict(), want, floats)


def test_multi_tile_distinct_f10(monkeypatch):
    """Reference fault F10: COUNT(DISTINCT) over several tiles."""
    sql = ("SELECT a.g, count(DISTINCT b.y) c, count(*) n FROM a, b WHERE a.x < b.y "
           "GROUP BY a.g ORDER BY a.g")
    jctx, pctx = _contexts()
    one = jctx.sql(sql).collect().to_pydict()
    monkeypatch.setattr(JJA, "TILE_ROWS", 1 << 12)
    monkeypatch.setattr(PJA, "TILE_ROWS", 1 << 12)
    jctx2, pctx2 = _contexts()
    tiled_jax = jctx2.sql(sql).collect().to_pydict()
    assert tiled_jax["n"] == one["n"] and tiled_jax["c"] != one["c"]
    assert all(t > o for t, o in zip(tiled_jax["c"], one["c"]))  # counted more than once
    for _ in range(3):
        assert pctx2.sql(sql).collect().to_pydict() == one


def test_string_min_max_f12(monkeypatch):
    sql = ("SELECT a.g, min(b.s) mn, max(b.s) mx FROM a, b WHERE a.x < b.y GROUP BY a.g "
           "ORDER BY a.g")
    jctx, pctx = _contexts()
    with pytest.raises(AssertionError):
        jctx.sql(sql).collect().to_pydict()  # the JAX package: no dictionary to decode
    a = jctx.table("a").collect().to_pandas()
    b = jctx.table("b").collect().to_pandas()
    j = a.merge(b, how="cross")
    j = j[j["x"] < j["y"]]
    exp = j.groupby("g", dropna=False)["s"].agg(["min", "max"]).reset_index()
    exp = exp.sort_values("g", na_position="last")
    want = {"g": [None if v != v else int(v) for v in exp["g"]],
            "mn": list(exp["min"]), "mx": list(exp["max"])}
    for tile_rows in (1 << 22, 1 << 10):
        monkeypatch.setattr(PJA, "TILE_ROWS", tile_rows)
        _, pctx = _contexts()
        for _ in range(3):
            got = pctx.sql(sql).collect().to_pydict()
            assert got == want


def test_plan_survives_a_rebuild():
    _, pctx = _contexts()
    sql = "SELECT a.g, count(*) c FROM a, b WHERE a.x < b.y GROUP BY a.g"
    phys = pctx.create_physical_plan(pctx.optimize(pctx.create_logical_plan(sql)))
    back = phys.with_new_children(phys.children())
    assert "CrossJoinAggExec" in back.display()
    assert "CrossJoinExec" not in back.display()


@pytest.mark.parametrize("tile_rows", [1 << 22, 1 << 10])
def test_warm_plan_is_one_unit(tile_rows, monkeypatch):
    monkeypatch.setattr(PJA, "TILE_ROWS", tile_rows)
    _, pctx = _contexts()
    sql = ("SELECT a.g, count(*) c, sum(a.x) s FROM (SELECT * FROM a WHERE a.x > 2) a, b "
           "WHERE a.x < b.y GROUP BY a.g ORDER BY a.g")
    for _ in range(3):
        s0 = HOST_SYNCS[0]
        out = pctx.sql(sql).collect()
        syncs = HOST_SYNCS[0] - s0
    wq = pctx._plan_cache[list(pctx._plan_cache)[-1]]._whole_query
    assert wq.is_program, wq.failure
    assert syncs == 1  # the flags' sum
    assert out.nrows == 6  # five groups and the NULL group
