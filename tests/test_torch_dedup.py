"""Shared-subtree deduplication in the torch port (physical/dedup.py) on
the CPU.

  * TPC-H Q15 at SF 0.01: the port's physical plan has the JAX package's
    shape (the revenue0 view fenced into its own stages, used by both the
    join and the scalar max), the same rows, and the view's stage executes
    once per collect, in the cold run, the check and every warm run.
  * The keys: a scan keys by its table object, so two scans of equal but
    distinct tables are never merged; an operator type the keys do not know
    keys by identity and is never merged; two equal subtrees become one
    object.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import re

import numpy as np

import datafusion_tpu as J

import datafusion_tpu_torch as D
from datafusion_tpu_torch.ops.basic import MemoryExec
from datafusion_tpu_torch.physical.dedup import DeduplicateSubtrees, ShareCommonSubtrees, _tree_key
from datafusion_tpu_torch.physical.fuse import StageExec
from datafusion_tpu_torch.queries import get_query_sql, run_tpch

from torch_parity import assert_rows_equal, port_table


def _q15_plan(ctx):
    stmts = [s for s in get_query_sql(15).split(";") if s.strip()]
    ctx.sql(stmts[0])  # create view revenue0
    plan = ctx.create_physical_plan(ctx.optimize(ctx.create_logical_plan(stmts[1])))
    ctx.sql(stmts[2])  # drop view
    return plan


def _nodes(plan, out=None):
    out = [] if out is None else out
    out.append(plan)
    for c in plan.children():
        _nodes(c, out)
    return out


def test_q15_runs_revenue0_once_per_collect():
    from torch_tpch import jax_tables

    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    for name, t in jax_tables().items():
        jctx.register_table(name, t)
        pctx.register_table(name, port_table(t))
    # equal but for the numbers of the subquery aliases (__sq_N), which
    # count the subqueries each process has planned
    shape = lambda ctx: re.sub(r"__sq_\d+", "__sq", _q15_plan(ctx).display())  # noqa: E731
    assert shape(pctx) == shape(jctx)
    want = run_tpch(jctx, 15).to_pydict()
    for i in range(4):  # the cold run, the check, two warm runs
        got = run_tpch(pctx, 15).to_pydict()
        assert_rows_equal(got, want)
        plan = pctx._plan_cache[list(pctx._plan_cache)[-1]]
        nodes = _nodes(plan)
        assert any(getattr(n, "_dedup_shared", False) for n in nodes), plan.display()
        stages = {id(n): n for n in nodes if isinstance(n, StageExec)}
        # the plan's tree shows the view's stage under both users; it is
        # one object, executed once by each collect
        assert len(stages) == 1
        (stage,) = stages.values()
        assert [id(n) for n in nodes].count(id(stage)) == 2
        assert stage.metrics.counter("executions").value == i + 1
    assert plan._whole_query.is_program


def _mem(values):
    t = D.Table.from_pydict({"a": values}, device="cpu")
    return MemoryExec(t, t.schema())


def test_keys_merge_only_equal_subtrees():
    from datafusion_tpu_torch.exprs.physical import PhysCol
    from datafusion_tpu_torch.ops.aggregate import HashAggregateExec, PhysAggExpr
    from datafusion_tpu_torch.ops.basic import UnionExec

    m1, m2 = _mem([1, 2, 3]), _mem([1, 2, 3])
    assert _tree_key(m1) != _tree_key(m2)  # equal data, distinct tables
    col = PhysCol("a", 0, m1.schema().fields[0].dtype)

    def agg(m):
        return HashAggregateExec("single", [(col, "a")], [PhysAggExpr("count", None, "c")], m)

    same = UnionExec([agg(m1), agg(m1)], agg(m1).schema())
    out = ShareCommonSubtrees().optimize(same)
    assert out.inputs[0] is out.inputs[1] and out.inputs[0]._dedup_shared
    apart = UnionExec([agg(m1), agg(m2)], agg(m1).schema())
    out = ShareCommonSubtrees().optimize(apart)
    assert out.inputs[0] is not out.inputs[1]
    assert out.execute().to_pydict()["c"] == [1] * 6


def test_unknown_operators_are_never_merged():
    class Opaque(MemoryExec):
        pass

    t = D.Table.from_pydict({"a": np.arange(3)}, device="cpu")
    a, b = Opaque(t, t.schema()), Opaque(t, t.schema())
    assert _tree_key(a)[0] == "id" and _tree_key(a) != _tree_key(b)
    from datafusion_tpu_torch.ops.basic import UnionExec

    u = DeduplicateSubtrees().optimize(UnionExec([a, b], t.schema()))
    assert u.inputs[0] is a and u.inputs[1] is b
