"""What the torch port keeps on its device between collects, and EXPLAIN
ANALYZE's row counts, on the CPU at SF 0.01 (``tests/torch_tpch.py``'s
tables, in both engines):

* each operator keeps only its last output's row count for EXPLAIN
  ANALYZE (``ops/base.py``), not the output itself: a cached plan that
  kept every operator's last table held tens of GiB on the card at SF10;
* EXPLAIN ANALYZE reports the same ``output_rows`` as the JAX package,
  for the whole result and summed per operator type;
* a released context's tables are freed: the shared stage cache
  (``physical/fuse.py``) holds a compiled stage, whose chain reaches its
  source table, only while a plan holds it.
"""

import gc
import weakref

import pytest
import torch

import datafusion_tpu as J
import datafusion_tpu_torch as D
from datafusion_tpu_torch.columnar.table import Table
from datafusion_tpu_torch.queries import get_query_sql

from torch_parity import port_table

QUERIES = (1, 3, 12, 18)


@pytest.fixture(scope="module")
def contexts():
    from torch_tpch import jax_tables

    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    for name, jt in jax_tables().items():
        jctx.register_table(name, jt)
        pctx.register_table(name, port_table(jt))
    return jctx, pctx


def _nodes(plan) -> list:
    seen, stack, out = set(), [plan], []
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        out.append(n)
        stack.extend(n.children())
        if getattr(n, "_source", None) is not None:
            stack.append(n._source)
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_cached_plan_keeps_row_counts_not_tables(contexts, q):
    _, pctx = contexts
    for _ in range(2):
        pctx.sql(get_query_sql(q)).collect()
    plan = pctx._plan_cache[list(pctx._plan_cache)[-1]]
    kept = [getattr(n, "_metrics_out", None) for n in _nodes(plan)]
    assert any(k is not None for k in kept)
    for k in kept:
        assert not isinstance(k, Table)
        assert k is None or isinstance(k, int) or (isinstance(k, torch.Tensor) and k.dim() == 0)


def _output_rows(ctx, q) -> list:
    rows = ctx.sql("EXPLAIN ANALYZE " + get_query_sql(q)).collect().to_pydict()
    assert rows["plan_type"][-1] == "metrics"
    return [line for line in rows["plan"][-1].splitlines() if "output_rows" in line]


@pytest.mark.parametrize("q", QUERIES)
def test_explain_analyze_output_rows_as_the_reference(contexts, q):
    jctx, pctx = contexts
    got = _output_rows(pctx, q)
    assert len(got) > 1
    assert got == _output_rows(jctx, q)


def test_released_context_frees_its_tables():
    from datafusion_tpu_torch.q1data import _lineitem_table, lineitem_q1_arrays

    ctx = D.ExecutionContext(device="cpu")
    table = _lineitem_table(lineitem_q1_arrays(0.001, 7), "cpu")
    ref = weakref.ref(table)
    ctx.register_table("lineitem", table)
    del table
    for _ in range(3):
        ctx.sql(get_query_sql(1)).collect().to_pydict()
    del ctx
    gc.collect()
    assert ref() is None
