"""Extension planner for RollingWindowAggregate.

Port of ``datafusion_tpu/physical/rolling_planner.py`` (reference:
cube_ext/rolling.rs:165, Planner::plan_extension).  The FROM, TO and EVERY
bounds are constant expressions, evaluated here on the host (on a
CPU table, so planning reads nothing from the card); frame offsets become
bucket offsets."""

from __future__ import annotations

from ..columnar.table import Table
from ..errors import PlanError
from ..logical.expr import Alias
from ..logical.rolling import RollingWindowAggregate
from ..ops.aggregate import PhysAggExpr
from ..ops.rolling import PhysRollingAgg, RollingWindowAggExec
from ..types import Field


class RollingWindowPlanner:
    def plan_extension(self, node, planner):
        if not isinstance(node, RollingWindowAggregate):
            return None
        from .planner import create_physical_expr

        input_exec = planner.create_physical_plan(node.input)
        in_schema = node.input.schema()
        dim_expr = create_physical_expr(node.dimension, in_schema)
        dim_f = in_schema.field_from_column(node.dimension.name, node.dimension.relation)
        dim_field = Field(dim_f.qualified_name, dim_f.dtype, True)

        def scalar_of(e, kind):
            """A constant expression's value on the host
            (expect_non_null_scalar, rolling.rs:196)."""
            col = create_physical_expr(e, in_schema).evaluate(
                Table.empty(in_schema.to_schema(), device="cpu")
            )
            if not bool(col.valid[0]):
                raise PlanError(f"{kind} must be a non-null constant")
            return int(col.data[0])

        from_v = scalar_of(node.from_, "FROM")
        to_v = scalar_of(node.to, "TO")
        every_v = scalar_of(node.every, "EVERY")
        if every_v <= 0:
            raise PlanError("EVERY must be positive")

        def bucket_offset(bound, is_start):
            """WindowFrameBound -> bucket offset (frame_bound_to_diff)."""
            if bound is None:
                return None if is_start else 0
            if bound.kind == "current":
                return 0
            if bound.offset is None:
                if bound.kind == "preceding" and is_start:
                    return None  # unbounded
                if bound.kind == "preceding":
                    raise PlanError("frame end UNBOUNDED PRECEDING is invalid")
                raise PlanError("UNBOUNDED FOLLOWING is not supported in ROLLING")
            if bound.offset % every_v != 0:
                raise PlanError(f"ROLLING offset {bound.offset} must be a multiple of EVERY")
            return bound.offset // every_v

        partition_by = []
        for p in node.partition_by:
            f = in_schema.field_from_column(p.name, p.relation)
            partition_by.append((create_physical_expr(p, in_schema), f.qualified_name))

        rolling_aggs = []
        for r in node.rolling_aggs:
            agg = r.agg
            arg = create_physical_expr(agg.args[0], in_schema) if agg.args else None
            pa = PhysAggExpr(agg.fun, arg, r.output_name(), agg.distinct)
            end = r.end
            if end is not None and end.kind == "following":
                post = bucket_offset(end, False)
            elif end is None or end.kind == "current":
                post = 0
            else:
                raise PlanError("ROLLING end bound must be CURRENT ROW or FOLLOWING")
            rolling_aggs.append(PhysRollingAgg(pa, bucket_offset(r.start, True), post))

        gbd = (
            create_physical_expr(node.group_by_dimension, in_schema)
            if node.group_by_dimension is not None
            else None
        )
        aggs = []
        for a in node.aggs:
            e = a.expr if isinstance(a, Alias) else a
            arg = create_physical_expr(e.args[0], in_schema) if e.args else None
            aggs.append(PhysAggExpr(e.fun, arg, a.output_name(), e.distinct))

        return RollingWindowAggExec(
            input_exec, dim_expr, dim_field, from_v, to_v, every_v,
            partition_by, rolling_aggs, gbd, aggs,
        )
