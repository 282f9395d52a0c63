"""TPC-H with lineitem host-resident (datafusion_tpu_torch/physical/
morsel.py) against the JAX package at SF 0.01: each of the 22 queries
streams the same stages (MorselJoinStageExec, MorselStageExec) and
materializes the same host scans in both engines, and gives the port's
device-resident rows (floats rel 1e-12, everything else exact); and
fault F14, a Parquet file's decimal row-group pruning, pinned."""

import numpy as np
import pytest

import datafusion_tpu as J
import datafusion_tpu_torch as D
from datafusion_tpu_torch.physical.morsel import MorselJoinStageExec, MorselStageExec

from torch_parity import port_table


@pytest.fixture(scope="module")
def tpch_host():
    """(JAX context, port context, port device-resident context): the TPC-H
    tables at SF 0.01, lineitem host-resident in morsels of 16,384 rows."""
    from torch_tpch import jax_tables

    jctx, pctx, dctx = J.ExecutionContext(), D.ExecutionContext(device="cpu"), D.ExecutionContext(device="cpu")
    for name, jt in jax_tables().items():
        pt = port_table(jt)
        dctx.register_table(name, pt)
        if name == "lineitem":
            jctx.register_host_table(name, jt, morsel_rows=1 << 14)
            pctx.register_host_table(name, pt, morsel_rows=1 << 14)
        else:
            jctx.register_table(name, jt)
            pctx.register_table(name, pt)
    return jctx, pctx, dctx


def _host_scans(plan, morsel_types, host_type, stage_type) -> tuple:
    """(streamed join stages, streamed scan stages, materialized host scans)."""
    seen, stack, out = set(), [plan], [0, 0, 0]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        for i, t in enumerate(morsel_types + (host_type,)):
            out[i] += isinstance(n, t)
        stack.extend(n.children())
        if isinstance(n, stage_type):
            stack.append(n._source)
    return tuple(out)


def _plans(ctx, q):
    """The physical plan of TPC-H query q's query statement (Q15's view
    created around it)."""
    from datafusion_tpu_torch.queries import get_query_sql

    plan = None
    for stmt in [s for s in get_query_sql(q).split(";") if s.strip()]:
        if "view" in stmt.lower():
            ctx.sql(stmt)
        else:
            plan = ctx.create_physical_plan(ctx.optimize(ctx.sql(stmt).logical_plan()))
    return plan


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_streams_as_the_reference(tpch_host, q):
    """With lineitem host-resident, each TPC-H query's plan streams the
    same stages (MorselJoinStageExec, MorselStageExec) and materializes
    the same scans in both engines, and the port's rows equal its
    device-resident rows."""
    import datafusion_tpu.datasource.host as jhost
    import datafusion_tpu.physical.fuse as jfuse
    import datafusion_tpu.physical.morsel as jmorsel
    from datafusion_tpu_torch.datasource.host import HostMemoryExec
    from datafusion_tpu_torch.physical.fuse import StageExec
    from datafusion_tpu_torch.queries import FULLY_ORDERED, run_tpch

    from torch_parity import assert_rows_equal

    jctx, pctx, dctx = tpch_host
    want = _host_scans(_plans(jctx, q), (jmorsel.MorselJoinStageExec, jmorsel.MorselStageExec),
                       jhost.HostMemoryExec, jfuse.StageExec)
    got = _host_scans(_plans(pctx, q), (MorselJoinStageExec, MorselStageExec), HostMemoryExec, StageExec)
    assert got == want
    rows = run_tpch(pctx, q)
    ref = run_tpch(dctx, q).to_pydict()
    if q not in FULLY_ORDERED:
        key = lambda r: tuple((v is None, v) for v in r)  # noqa: E731
        ordered = lambda d: dict(zip(d, map(list, zip(*sorted(zip(*d.values()), key=key))))) if d else d  # noqa: E731
        got_rows, ref = ordered(rows.to_pydict()), ordered(ref)
    else:
        got_rows = rows.to_pydict()
    floats = [n for n, c in zip(rows.names, rows.columns) if c.dtype.is_float]
    assert_rows_equal(got_rows, ref, floats)


def test_parquet_decimal_pruning_f14(tmp_path):
    """Fault F14: row-group pruning on a decimal column.  The port prunes
    in the domain the engine compares float literals in, so a Q6-shaped
    filter over a Parquet file gives numpy's sum device-resident (pruned)
    and host-resident (streamed); the JAX package prunes every group and
    returns NULL."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(9)
    n = 4000
    qty = np.sort(rng.integers(100, 5000, n))  # scaled by 100: 1.00-49.99
    price = rng.integers(10_000, 1_000_000, n)

    def dec(v):
        return pa.array([f"{x // 100}.{x % 100:02d}" for x in v]).cast(pa.decimal128(15, 2))

    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"q": dec(qty), "p": dec(price)}), path, row_group_size=1000)
    sql = "SELECT sum(p) s FROM t WHERE q < 24 AND q >= 0.06 - 0.01"
    m = (qty < 2400) & (qty >= 5)
    want = {"s": [int(price[m].sum()) / 100]}
    for kw in ({}, {"morsel_rows": 1024}):
        pctx = D.ExecutionContext(device="cpu")
        pctx.register_parquet("t", path, **kw)
        assert pctx.sql(sql).collect().to_pydict() == want, kw
    jctx = J.ExecutionContext()
    jctx.register_parquet("t", path)
    assert jctx.sql(sql).collect().to_pydict() == {"s": [None]}
