"""The torch port's mesh layer (datafusion_tpu_torch/parallel) against the
JAX package's on the same numpy inputs, on the CPU: 8 shards (the JAX
package's 8 virtual devices), and 1 and 3 shards (empty shards, a shard
count that is not a power of two).  The joins are in
test_torch_parallel_joins.py.

Both engines place rows alike (``from_table``'s ceil(n/ndev) blocks) and
hash alike bit for bit, so every shard holds the same rows in both after
every operator: rows compare shard by shard, as multisets (keys, counts,
integer and decimal sums exact; floats within rel 1e-12 of
max(|want|, 1)).  Overflow counts and the exchange statistics that drive
retries and EXPLAIN compare exactly.  The last test is the port's
counterpart of ``__graft_entry__.dryrun_multichip``'s body."""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

import datafusion_tpu as J
import datafusion_tpu.parallel.mesh as jmesh

import datafusion_tpu_torch as D
import datafusion_tpu_torch.exprs.physical as pexp
import datafusion_tpu_torch.ops.aggregate as pagg
import datafusion_tpu_torch.ops.sort as psort
import datafusion_tpu_torch.parallel.executor as pexec
import datafusion_tpu_torch.parallel.mesh as pmesh
import datafusion_tpu_torch.parallel.ops as pops
import datafusion_tpu_torch.types as ptypes
import datafusion_tpu_torch.types.dtypes as pdt

from torch_mesh import E, SHARDS, assert_same_rows, assert_same_shards, both, col, data, shards_rows, tables, one_torch_thread  # noqa: F401 (autouse fixture)

@pytest.mark.parametrize("n", SHARDS)
def test_sharded_table_round_trips(n):
    r = both(lambda e, t, st: (st.total_rows(), np.asarray(st.nrows).tolist(), st.shard_cap,
                               shards_rows(st), st.to_table().to_pydict()), n_shards=n)
    assert r["port"][:3] == r["jax"][:3]
    assert r["port"][3] == r["jax"][3]  # shard by shard, in order
    assert r["port"][4] == r["jax"][4] == tables(data())["jax"].to_pydict()
    st = pmesh.ShardedTable.from_table(tables(data())["port"], pmesh.make_mesh(n, device="cpu"))
    small = st.shrink()
    assert small.shard_cap <= st.shard_cap and small.to_table().to_pydict() == st.to_table().to_pydict()


@pytest.mark.parametrize("n", SHARDS)
def test_dist_filter_project(n):
    def build(e, t, st):
        pred = e.exp.PhysBinary(col(e, t, "v"), ">", e.exp.PhysLit(e.types.ScalarValue.int64(100)),
                                e.dt.BOOL)
        f = e.ops.dist_filter(st, pred)
        p = e.ops.dist_project(f, [
            (col(e, t, "k"), "k"),
            (e.exp.PhysBinary(col(e, t, "v"), "*", e.exp.PhysLit(e.types.ScalarValue.int64(3)),
                              e.dt.INT64), "v3"),
            (col(e, t, "f"), "f"),
        ])
        return shards_rows(f), shards_rows(p)

    r = both(build, n_shards=n)
    assert_same_shards(r["port"][0], r["jax"][0])
    assert_same_shards(r["port"][1], r["jax"][1])


def _aggs(e, t):
    return [
        e.agg.PhysAggExpr("sum", col(e, t, "v"), "s"),
        e.agg.PhysAggExpr("count", None, "c"),
        e.agg.PhysAggExpr("count", col(e, t, "f"), "cf"),
        e.agg.PhysAggExpr("min", col(e, t, "k"), "mn"),
        e.agg.PhysAggExpr("max", col(e, t, "f"), "mx"),
        e.agg.PhysAggExpr("avg", col(e, t, "f"), "a"),
    ]


@pytest.mark.parametrize("n,bucket", [(8, None), (8, 4096), (3, None)])
def test_dist_aggregate(n, bucket):
    def build(e, t, st):
        grouped = e.ops.dist_aggregate(st, [(col(e, t, "k"), "k")], _aggs(e, t), bucket_cap=bucket)
        glob = e.ops.dist_aggregate(st, [], _aggs(e, t))
        dist = e.ops.dist_aggregate(st, [], [
            e.agg.PhysAggExpr("count", col(e, t, "v"), "cd", distinct=True),
            e.agg.PhysAggExpr("sum", col(e, t, "v"), "sd", distinct=True),
            e.agg.PhysAggExpr("count", None, "c"),
        ])
        info = {k: v for k, v in grouped.exchange_info.items()}
        return shards_rows(grouped), shards_rows(glob), shards_rows(dist), info, grouped.shard_cap

    r = both(build, n_shards=n)
    for i in range(3):
        assert_same_shards(r["port"][i], r["jax"][i])
    assert r["port"][3:] == r["jax"][3:]


@pytest.mark.parametrize("n", SHARDS)
def test_dist_aggregate_exact(n):
    def build(e, t, st):
        aggs = [e.agg.PhysAggExpr("count", col(e, t, "v"), "cd", distinct=True),
                e.agg.PhysAggExpr("sum", col(e, t, "f"), "s")]
        op = e.agg.HashAggregateExec("single", [(col(e, t, "k"), "k")], aggs, None)
        out, ovf = e.ops.dist_aggregate_exact(st, op)
        return shards_rows(out), ovf, out.exchange_info

    r = both(build, n_shards=n)
    assert_same_shards(r["port"][0], r["jax"][0])
    assert r["port"][1:] == r["jax"][1:]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("bucket", [None, 4096, 2 * 4096])
def test_dist_sort(n, bucket):
    def build(e, t, st):
        specs = [e.sort.PhysSortExpr(col(e, t, "f"), ascending=False, nulls_first=True),
                 e.sort.PhysSortExpr(col(e, t, "k")), e.sort.PhysSortExpr(col(e, t, "i"))]
        out, ovf = e.ops.dist_sort(st, specs, bucket_cap=bucket)
        return shards_rows(out), ovf, out.exchange_info, out.to_table().to_pydict()

    d = data(3000, 5)
    r = both(build, d, n_shards=n)
    assert r["port"][1:3] == r["jax"][1:3]
    assert_same_shards(r["port"][0], r["jax"][0])
    assert r["port"][3] == r["jax"][3]  # the total order, row for row


def _window_exprs(e, t, partitioned: bool):
    i_col, v_col, k_col = col(e, t, "i"), col(e, t, "v"), col(e, t, "k")
    pby = [k_col] if partitioned else []
    oby = [e.sort.PhysSortExpr(v_col), e.sort.PhysSortExpr(i_col)]
    u64, i64, f64 = e.dt.UINT64, e.dt.INT64, e.dt.FLOAT64
    lit2 = e.exp.PhysLit(e.types.ScalarValue.int64(2))
    return [
        e.win.PhysWindowExpr("row_number", [], pby, oby, "rn", u64),
        e.win.PhysWindowExpr("rank", [], pby, oby[:1], "rk", u64),
        e.win.PhysWindowExpr("sum", [v_col], pby, oby, "rs", i64),
        e.win.PhysWindowExpr("lag", [v_col, lit2], pby, oby, "lg", i64),
        e.win.PhysWindowExpr("avg", [col(e, t, "f")], pby, oby[:1], "af", f64),
    ]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("partitioned", [True, False])
def test_dist_window(n, partitioned):
    def build(e, t, st):
        ws = _window_exprs(e, t, partitioned)
        fn = e.ops.dist_window if partitioned else e.ops.dist_window_global
        out, ovf = fn(st, ws)
        return shards_rows(out), ovf, out.exchange_info

    r = both(build, n_shards=n)
    assert_same_shards(r["port"][0], r["jax"][0])
    assert r["port"][1:] == r["jax"][1:]


@pytest.mark.parametrize("n", SHARDS)
def test_dist_union_limit_skip(n):
    d2 = {"k": ["a", None, "zz"], "v": [1, 2, 3], "f": [0.5, None, -1.0], "i": [7, 8, 9]}
    t2s = tables(d2)

    def build(e, t, st):
        mesh = st.mesh
        st2 = e.mesh.ShardedTable.from_table(t2s["jax" if e is E["jax"] else "port"], mesh)
        u = e.ops.dist_union([st, st2], t.schema())
        lim = e.ops.dist_limit(st, 77)
        skip = e.ops.dist_skip(st, 250)
        return (shards_rows(u), u.shard_cap, shards_rows(lim), lim.to_table().to_pydict(),
                shards_rows(skip), skip.to_table().to_pydict())

    r = both(build, n_shards=n)
    for i in (0, 2, 4):
        assert_same_shards(r["port"][i], r["jax"][i])
    assert r["port"][1] == r["jax"][1]
    assert r["port"][3] == r["jax"][3] and r["port"][5] == r["jax"][5]


@pytest.mark.parametrize("n", SHARDS)
def test_collect_partitioned_shard_by_shard(n):
    """``collect_partitioned(mesh=)`` of a SQL query: the same rows on each
    shard in both engines, and their union the collect."""
    sql = ("SELECT k, count(*) AS c, sum(v) AS s FROM t WHERE v > 0 GROUP BY k")
    ts = tables(data())
    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    jctx.register_table("t", ts["jax"])
    pctx.register_table("t", ts["port"])
    want = [p.to_pydict() for p in jctx.sql(sql).collect_partitioned(mesh=jmesh.make_mesh(n))]
    got = [p.to_pydict() for p in pctx.sql(sql).collect_partitioned(mesh=pmesh.make_mesh(n, device="cpu"))]
    assert_same_shards(got, want)
    union = {k: [x for p in got for x in p[k]] for k in got[0]}
    assert_same_rows(union, pctx.sql(sql).collect().to_pydict())


def test_dryrun_multichip_body_on_the_port(monkeypatch):
    """The body of ``__graft_entry__.dryrun_multichip(8)`` on the port,
    strict: filter -> aggregate, a partitioned join, a range sort, mesh
    SQL equal to the single device, and TPC-H Q1, Q3 and Q4 at SF 0.002
    over the mesh equal to the single device (the JAX package's dryrun
    reads TPC-H text it does not carry)."""
    from datafusion_tpu_torch import tpchdata
    from datafusion_tpu_torch.queries import run_tpch, run_tpch_spmd

    monkeypatch.setenv("DFTPU_SPMD_STRICT", "1")
    e = E["port"]
    mesh = e.make_mesh(8)
    n = 512
    t = D.Table.from_pydict({"g": [f"k{i % 13}" for i in range(n)], "v": [float(i % 29) for i in range(n)],
                             "id": list(range(n))}, device="cpu")
    st = pmesh.ShardedTable.from_table(t, mesh)
    pred = pexp.PhysBinary(pexp.PhysCol("v", 1, pdt.FLOAT64), ">",
                           pexp.PhysLit(ptypes.ScalarValue.float64(3.0)), pdt.BOOL)
    agg = pops.dist_aggregate(pops.dist_filter(st, pred), [(pexp.PhysCol("g", 0, pdt.STRING), "g")], [
        pagg.PhysAggExpr("count", None, "c"), pagg.PhysAggExpr("sum", pexp.PhysCol("v", 1, pdt.FLOAT64), "s"),
        pagg.PhysAggExpr("avg", pexp.PhysCol("v", 1, pdt.FLOAT64), "a")])
    assert agg.to_table().nrows == 13
    dim = D.Table.from_pydict({"g2": [f"k{i}" for i in range(13)], "w": list(range(13))}, device="cpu")
    j = pops.dist_join(st, pmesh.ShardedTable.from_table(dim, mesh),
                       [(pexp.PhysCol("g", 0, pdt.STRING), pexp.PhysCol("g2", 0, pdt.STRING))])
    assert j.to_table().nrows == n
    ss, ovf = pops.dist_sort(st, [psort.PhysSortExpr(pexp.PhysCol("v", 1, pdt.FLOAT64), ascending=False)])
    vs = ss.to_table().to_pydict()["v"]
    assert ovf == 0 and vs == sorted(vs, reverse=True)
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table("t", t)
    for q in [
        "SELECT g, id, row_number() OVER (PARTITION BY g ORDER BY v, id) AS rn FROM t ORDER BY g, id LIMIT 40",
        "SELECT g, count(DISTINCT v) AS cd FROM t GROUP BY g ORDER BY g",
        "SELECT id FROM t ORDER BY v, id LIMIT 7 OFFSET 3",
    ]:
        assert ctx.sql(q).collect().to_pydict() == ctx.sql(q).collect(mesh=mesh).to_pydict(), q
    tctx = D.ExecutionContext(device="cpu")
    tpchdata.register_tpch(tctx, tpchdata.generate_tpch(0.002, 7))
    for q in (1, 3, 4):
        ex = pexec.SpmdExecutor(mesh)
        assert ex.strict
        assert_same_rows(run_tpch_spmd(tctx, q, ex).to_pydict(), run_tpch(tctx, q).to_pydict())
        assert ex.fallback_count == 0
