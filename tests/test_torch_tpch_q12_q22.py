"""TPC-H Q12-Q22 in the torch port against the JAX package and the pandas
oracle on the CPU at SF 0.01 (see tests/torch_tpch.py for what each check
compares and its tolerance); and the fused tail above a join."""

import pytest

import datafusion_tpu as J
import datafusion_tpu_torch as D
from datafusion_tpu_torch.queries import get_query_sql

from torch_parity import port_table
from torch_tpch import check_against_jax, check_against_pandas, jax_tables

QUERIES = range(12, 23)


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_query_matches_jax(q, monkeypatch):
    check_against_jax(q, monkeypatch)


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_query_matches_pandas(q):
    check_against_pandas(q)


def test_q12_tail_fused_above_the_join():
    """Q12's aggregate, projection and sort run as one fused tail above the
    join, as in the JAX package."""
    tables = jax_tables()
    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    for name in ("lineitem", "orders"):
        jctx.register_table(name, tables[name])
        pctx.register_table(name, port_table(tables[name]))
    sql = get_query_sql(12).rstrip().rstrip(";")
    plans = []
    for ctx in (jctx, pctx):
        plan = ctx.create_physical_plan(ctx.optimize(ctx.create_logical_plan(sql)))
        lines = [l.strip() for l in plan.display().splitlines()]
        plans.append([l.split(":")[0] for l in lines[:2]])
    assert plans[1] == plans[0]
    assert plans[1] == ["TailStageExec[fused x3 root]", "HashJoinExec[inner]"]
