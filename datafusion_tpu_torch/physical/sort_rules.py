"""Physical optimizer rules that read ``output_sort_order()`` hints.

Port of ``datafusion_tpu/physical/sort_rules.py``.  Reference equivalents:
  SortedAggregateRule     planner.rs:1667 compute_aggregation_strategy:
                          AggregateStrategy::InplaceSorted when the input
                          is already sorted on the group keys
  EliminateRedundantSort  the OptimizerHints consumers (merge planning,
                          planner.rs:753-851, picks MergeJoin over a
                          re-sort)
"""

from __future__ import annotations

from ..exprs.physical import PhysCol
from ..ops.aggregate import HashAggregateExec
from ..ops.base import ExecutionPlan
from ..ops.sort import SortExec
from ..ops.sorted import SortedAggregateExec


def _rewrite(plan: ExecutionPlan, fn) -> ExecutionPlan:
    kids = plan.children()
    if kids:
        plan = plan.with_new_children([_rewrite(c, fn) for c in kids])
    return fn(plan)


class SortedAggregateRule:
    """HashAggregate -> SortedAggregate when the input's guaranteed sort
    order leads with exactly the group-key columns."""

    name = "sorted_aggregate"

    def optimize(self, plan: ExecutionPlan) -> ExecutionPlan:
        def fn(p):
            if not isinstance(p, HashAggregateExec) or not p.group_expr:
                return p
            if any(a.distinct for a in p.aggr_expr):
                return p
            order = p.input.output_sort_order()
            if order is None:
                return p
            key_idx = []
            for e, _ in p.group_expr:
                if not isinstance(e, PhysCol):
                    return p
                key_idx.append(e.index)
            # grouping needs only equal keys adjacent, in either direction
            if sorted(i for i, _, _ in order[: len(key_idx)]) != sorted(key_idx):
                return p
            return SortedAggregateExec(p.mode, p.group_expr, p.aggr_expr, p.input)

        return _rewrite(plan, fn)


class EliminateRedundantSort:
    """Drop a SortExec whose input already guarantees the requested order."""

    name = "eliminate_redundant_sort"

    def optimize(self, plan: ExecutionPlan) -> ExecutionPlan:
        def fn(p):
            if not isinstance(p, SortExec) or p.fetch is not None:
                return p
            want = p.output_sort_order()
            have = p.input.output_sort_order()
            if want is None or have is None:
                return p
            return p.input if have[: len(want)] == want else p

        return _rewrite(plan, fn)
