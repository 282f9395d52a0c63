"""Extension planner for CrossJoinAgg.

Port of ``datafusion_tpu/physical/joinagg_planner.py`` (reference:
cube_ext/joinagg.rs:144, CrossJoinAggPlanner::plan_extension): plans the
fused node's group and aggregate expressions against the joined schema,
as the reference plans them against the physical join schema
(joinagg.rs:163-183)."""

from __future__ import annotations

from ..logical.joinagg import CrossJoinAgg
from ..ops.joinagg import CrossJoinAggExec


class CrossJoinAggPlanner:
    def plan_extension(self, node, planner):
        if not isinstance(node, CrossJoinAgg):
            return None
        from .planner import create_physical_expr

        joined = node.join_schema()
        condition = (
            create_physical_expr(node.condition, joined) if node.condition is not None else None
        )
        agg = planner._aggregate_exec(
            None, joined, node.schema().fields, node.group_expr, node.aggr_expr
        )
        return CrossJoinAggExec(
            planner.create_physical_plan(node.left),
            planner.create_physical_plan(node.right),
            condition,
            agg.group_expr,
            agg.aggr_expr,
        )
