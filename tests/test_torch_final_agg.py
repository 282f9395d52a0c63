"""Final-mode aggregation (the merge of partial states,
datafusion_tpu_torch/ops/aggregate.py ``merge_states``) against the JAX
package's ``_execute_final``.

Random partial-state tables with nulls, in the layout a partial
aggregate emits ([keys, distinct values, states]), go through
HashAggregateExec("final", ...) in both engines: keys, counts and integer
sums exactly equal, floats within rel 1e-12.  Also: partial -> final over
raw rows equals the single-phase aggregate in the port, a user-defined
aggregate's state merges as the reference's does, and the twin of
tests/test_operators.py::test_two_phase_agg_matches_single_phase is in
test_torch_final_agg_twins.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.exprs.physical import PhysCol as JCol
from datafusion_tpu.functions.udf import create_udaf as jcreate_udaf
from datafusion_tpu.ops.aggregate import HashAggregateExec as JAgg
from datafusion_tpu.ops.aggregate import PhysAggExpr as JAggExpr
from datafusion_tpu.ops.basic import MemoryExec as JMem
from datafusion_tpu.types import dtypes as JT
from datafusion_tpu_torch.exprs.physical import PhysCol
from datafusion_tpu_torch.functions.udf import create_udaf
from datafusion_tpu_torch.ops.aggregate import HashAggregateExec, PhysAggExpr
from datafusion_tpu_torch.ops.basic import MemoryExec
from datafusion_tpu_torch.types import dtypes as PT

from torch_parity import port_table

REL = 1e-12


def _nulls(rng, vals, p=0.15):
    return [None if z else v for z, v in zip(rng.random(len(vals)) < p, vals)]


def _states(n: int, seed: int) -> dict:
    """Partial states of: count(*), sum(int x), avg(float y), min(y),
    max(string s), var_samp(y), and two DISTINCT aggregates' value
    columns, grouped by (g, k)."""
    rng = np.random.default_rng(seed)
    cnt = [int(v) for v in rng.integers(0, 5, n)]
    return {
        "g": _nulls(rng, list(rng.choice(["a", "bb", "c", "dd"], n))),
        "k": _nulls(rng, [int(v) for v in rng.integers(-3, 4, n)]),
        "__dv0": _nulls(rng, [int(v) for v in rng.integers(0, 6, n)]),
        "__dv1": _nulls(rng, [int(v) for v in rng.integers(-2, 3, n)]),
        "c[count]": cnt,
        "s[sum]": _nulls(rng, [int(v) for v in rng.integers(-10**12, 10**12, n)]),
        "s[count]": cnt,
        "a[sum]": [float(v) for v in rng.normal(size=n) * 100],
        "a[count]": cnt,
        "lo[min]": _nulls(rng, [float(v) for v in rng.normal(size=n)]),
        "lo[count]": _nulls(rng, cnt),
        "hi[max]": _nulls(rng, list(rng.choice(["p", "q", "r", "s"], n))),
        "hi[count]": cnt,
        "v[n]": cnt,
        "v[sum]": [float(v) for v in rng.normal(size=n)],
        "v[sumsq]": [float(v) for v in rng.random(n) * 10],
    }


def _aggs(Agg, Col, T):
    x, y, s, z = Col("x", 90, T.INT64), Col("y", 91, T.FLOAT64), Col("s", 92, T.STRING), Col("z", 93, T.INT64)
    return [
        Agg("count", None, "c"),
        Agg("count", z, "cd", distinct=True),
        Agg("sum", x, "s"),
        Agg("avg", y, "a"),
        Agg("min", y, "lo"),
        Agg("max", s, "hi"),
        Agg("sum", z, "sd", distinct=True),
        Agg("var_samp", y, "v"),
    ]


def _final(Agg, AggExpr, Col, Mem, T, table, aggs=None, distinct_values=2):
    group = [(Col("g", 0, T.STRING), "g"), (Col("k", 1, T.INT64), "k")]
    aggs = aggs if aggs is not None else _aggs(AggExpr, Col, T)
    op = Agg("final", group, aggs, Mem(table, table.schema()), distinct_values=distinct_values)
    return op.execute()


def assert_same(pt, want: dict):
    got = pt.to_pydict()
    assert list(got) == list(want)
    for name, c in zip(pt.names, pt.columns):
        assert len(got[name]) == len(want[name]), name
        for x, y in zip(got[name], want[name]):
            if c.dtype.is_float and x is not None and y is not None:
                assert (math.isnan(x) and math.isnan(y)) or abs(x - y) <= REL * max(abs(y), 1.0), (name, x, y)
            else:
                assert x == y, (name, x, y)


@pytest.mark.parametrize("n,seed", [(50, 0), (3000, 1), (9000, 2)])
def test_final_merge_matches_jax(n, seed):
    jt = JTable.from_pydict(_states(n, seed), dtypes={"hi[max]": JT.STRING})
    want = _final(JAgg, JAggExpr, JCol, JMem, JT, jt).to_pydict()
    got = _final(HashAggregateExec, PhysAggExpr, PhysCol, MemoryExec, PT, port_table(jt))
    assert got.nrows == len(want["g"]) > 1
    assert_same(got, want)


def test_final_merge_no_keys_matches_jax():
    jt = JTable.from_pydict({k: v for k, v in _states(700, 3).items() if k not in ("g", "k", "__dv0", "__dv1")})
    ports = port_table(jt)

    def run(Agg, AggExpr, Col, Mem, T, table):
        aggs = [a for a in _aggs(AggExpr, Col, T) if not a.distinct]
        return Agg("final", [], aggs, Mem(table, table.schema())).execute()

    want = run(JAgg, JAggExpr, JCol, JMem, JT, jt).to_pydict()
    assert_same(run(HashAggregateExec, PhysAggExpr, PhysCol, MemoryExec, PT, ports), want)


def test_partial_then_final_equals_single():
    """Over raw rows with nulls: partial (grouping by keys + distinct
    values) then final gives the single-phase rows in the port."""
    from datafusion_tpu_torch.columnar.table import Table
    from datafusion_tpu_torch.physical.morsel import _attach_partial_agg

    rng = np.random.default_rng(4)
    n = 4000
    data = {
        "g": _nulls(rng, list(rng.choice(["a", "b", "c"], n))),
        "x": _nulls(rng, [int(v) for v in rng.integers(-50, 50, n)]),
        "y": _nulls(rng, [float(v) for v in rng.normal(size=n)]),
        "s": _nulls(rng, list(rng.choice(["p", "q", "r"], n))),
        "z": _nulls(rng, [int(v) for v in rng.integers(0, 9, n)]),
    }
    t = Table.from_pydict(data, device="cpu")

    def c(name):
        i = t.names.index(name)
        return PhysCol(name, i, t.columns[i].dtype)

    aggs = [
        PhysAggExpr("count", None, "c"), PhysAggExpr("count", c("z"), "cd", distinct=True),
        PhysAggExpr("sum", c("x"), "s"), PhysAggExpr("avg", c("y"), "a"),
        PhysAggExpr("min", c("y"), "lo"), PhysAggExpr("max", c("s"), "hi"),
        PhysAggExpr("sum", c("z"), "sd", distinct=True), PhysAggExpr("stddev", c("y"), "v"),
    ]
    group = [(c("g"), "g")]
    single = HashAggregateExec("single", group, aggs, MemoryExec(t, t.schema())).execute()
    partial, ndv = _attach_partial_agg(HashAggregateExec("single", group, aggs, None),
                                       MemoryExec(t, t.schema()))
    ps = partial.schema()
    final = HashAggregateExec("final", [(PhysCol("g", 0, ps.fields[0].dtype), "g")], aggs, partial,
                              distinct_values=ndv)
    assert_same(final.execute(), single.to_pydict())


def test_udaf_state_merges_like_jax():
    """A user-defined aggregate's (accumulator, count) state merges through
    its step as the reference's does; each engine gets its own lambdas."""
    rng = np.random.default_rng(5)
    n = 2000
    cnt = [int(v) for v in rng.integers(0, 3, n)]
    data = {
        "g": [int(v) for v in rng.integers(0, 6, n)],
        "p[acc]": _nulls(rng, [int(v) for v in rng.integers(-3, 4, n)]),
        "p[count]": cnt,
        "m[acc]": [float(v) for v in rng.normal(size=n)],
        "m[count]": cnt,
    }
    jt = JTable.from_pydict(data)
    judafs = [
        jcreate_udaf("prod", JT.INT64, JT.INT64, zero=1, step=lambda a, b: a * b),
        jcreate_udaf("mx", JT.FLOAT64, JT.FLOAT64, zero=-np.inf, step=lambda a, b: jnp.maximum(a, b),
                     finalize=lambda acc, c: acc * 2.0),
    ]
    pudafs = [
        create_udaf("prod", PT.INT64, PT.INT64, zero=1, step=lambda a, b: a * b),
        create_udaf("mx", PT.FLOAT64, PT.FLOAT64, zero=-np.inf, step=lambda a, b: torch.maximum(a, b),
                    finalize=lambda acc, c: acc * 2.0),
    ]

    def run(Agg, AggExpr, Col, Mem, T, table, udafs):
        aggs = [AggExpr("prod", Col("x", 9, T.INT64), "p", udf=udafs[0]),
                AggExpr("mx", Col("y", 9, T.FLOAT64), "m", udf=udafs[1])]
        return Agg("final", [(Col("g", 0, T.INT64), "g")], aggs, Mem(table, table.schema())).execute()

    want = run(JAgg, JAggExpr, JCol, JMem, JT, jt, judafs).to_pydict()
    assert_same(run(HashAggregateExec, PhysAggExpr, PhysCol, MemoryExec, PT, port_table(jt), pudafs), want)
