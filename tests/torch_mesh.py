"""Helpers shared by the torch port's mesh tests: each engine's modules and
the same inputs in both, TPC-H at SF 0.002 in both engines, a query run
over a mesh with an explicit SPMD executor (its per-node modes recorded),
and row comparisons that ignore row order."""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench.tpch_datagen import DATE_COLUMNS, DECIMAL_COLUMNS, generate_tpch
import datafusion_tpu.exprs.physical as jexp
import datafusion_tpu.ops.aggregate as jagg
import datafusion_tpu.ops.sort as jsort
import datafusion_tpu.ops.window as jwin
import datafusion_tpu.parallel.executor as jexec
import datafusion_tpu.parallel.mesh as jmesh
import datafusion_tpu.parallel.ops as jops
import datafusion_tpu.types as jtypes
import datafusion_tpu.types.dtypes as jdt
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.types.dtypes import DATE32 as JDATE32, decimal as jdecimal

import datafusion_tpu_torch.exprs.physical as pexp
import datafusion_tpu_torch.ops.aggregate as pagg
import datafusion_tpu_torch.ops.sort as psort
import datafusion_tpu_torch.ops.window as pwin
import datafusion_tpu_torch.parallel.executor as pexec
import datafusion_tpu_torch.parallel.mesh as pmesh
import datafusion_tpu_torch.parallel.ops as pops
import datafusion_tpu_torch.types as ptypes
import datafusion_tpu_torch.types.dtypes as pdt
from datafusion_tpu_torch.queries import get_query_sql

from torch_parity import assert_rows_equal, port_table

SF = 0.002
CORE = [1, 3, 4, 13, 16, 21, 22]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a mesh test module's torch ops on one thread: a mesh runs many
    small ops per shard, and torch's worker threads, competing with the
    other test processes' for the cores, slowed them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# each engine's modules, for tests that build the same operators in both
E = {
    "jax": SimpleNamespace(exp=jexp, agg=jagg, sort=jsort, win=jwin, ops=jops, mesh=jmesh,
                           exec=jexec, types=jtypes, dt=jdt,
                           make_mesh=lambda n: jmesh.make_mesh(n)),
    "port": SimpleNamespace(exp=pexp, agg=pagg, sort=psort, win=pwin, ops=pops, mesh=pmesh,
                            exec=pexec, types=ptypes, dt=pdt,
                            make_mesh=lambda n: pmesh.make_mesh(n, device="cpu")),
}
SHARDS = [8, 1, 3]


def tables(d: dict, dtypes=None):
    jt = JTable.from_pydict(d, dtypes=dtypes)
    return {"jax": jt, "port": port_table(jt)}


def data(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "k": [None if i % 11 == 0 else f"key{int(x)}" for i, x in enumerate(rng.integers(0, 23, n))],
        "v": rng.integers(-500, 1000, n).tolist(),
        "f": [None if i % 7 == 0 else float(x) for i, x in enumerate(rng.normal(0, 100, n))],
        "i": list(range(n)),
    }


def col(e, t, name):
    i = t.names.index(name)
    return e.exp.PhysCol(name, i, t.columns[i].dtype)


def shards_rows(st) -> list:
    return [p.to_pydict() for p in st.shard_tables()]


def assert_same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_rows(g, w)


def both(build, d=None, n_shards=8, dtypes=None):
    """``build(e, table, sharded)`` in each engine on the same input; returns
    {engine: result}."""
    ts = tables(d or data(), dtypes)
    out = {}
    for name, e in E.items():
        mesh = e.make_mesh(n_shards)
        out[name] = build(e, ts[name], e.mesh.ShardedTable.from_table(ts[name], mesh))
    return out


@functools.lru_cache(maxsize=2)
def jax_tables(sf: float = SF) -> dict:
    """The eight tables as the JAX package's Tables, typed as
    ``bench/tpch.py::load_engine_tables`` types them."""
    out = {}
    for name, cols in generate_tpch(sf).items():
        dtypes = {n: JDATE32 for n in cols if n in DATE_COLUMNS}
        dtypes.update({n: jdecimal(15, 2) for n in cols if n in DECIMAL_COLUMNS})
        out[name] = JTable.from_pydict(cols, dtypes=dtypes)
    return out


def run_on_mesh(ctx, q: int, mesh, executor_cls):
    """TPC-H query q's statements on ``ctx``, the query itself through a
    fresh strict ``executor_cls(mesh)`` over the context's raw physical
    plan (both engines have ``create_physical_plan_for_mesh``).  Returns
    (result as a dict of columns, the executor)."""
    result, ex = None, None
    for stmt in get_query_sql(q).split(";"):
        low = stmt.lower()
        if not stmt.strip():
            continue
        if "create view" in low or "drop view" in low:
            ctx.sql(stmt)
            continue
        plan = ctx.create_logical_plan(stmt)
        ex = executor_cls(mesh, strict=True)
        out = ex.execute_plan(ctx.create_physical_plan_for_mesh(plan))
        display = [f.name for f in plan.schema().fields]
        result = dict(zip(display, out.to_pydict().values()))
    return result, ex


def _key(row):
    return tuple(
        (x is None, float(f"{x:.9g}") if isinstance(x, float) and not math.isnan(x) else x)
        for x in row
    )


def assert_same_rows(got: dict, want: dict) -> None:
    """The same rows in any order: keys, counts, integers and decimals
    exact, floats within rel 1e-12 of max(|want|, 1) (torch_parity)."""
    assert list(got) == list(want)

    def ordered(d):
        rows = sorted(zip(*d.values()), key=_key)
        return {k: [r[i] for r in rows] for i, k in enumerate(d)}

    floats = {k for k, v in want.items() if any(isinstance(x, float) for x in v)}
    assert_rows_equal(ordered(got), ordered(want), floats)
