"""DefaultPhysicalPlanner: LogicalPlan -> ExecutionPlan.

Port of ``datafusion_tpu/physical/planner.py`` (reference:
datafusion/src/physical_plan/planner.rs, create_initial_plan :341):
recursively maps logical nodes to physical operators, and
create_physical_expr binds expressions to input schemas by column index.
Extension nodes go to the extension planners (ROLLING_WINDOW and
CrossJoinAgg); user-defined functions raise PlanError naming the slice
that ports them.

Naming contract: a physical Table's column names are the *qualified* names
of the producing logical node's DFSchema, so column lookup inside operators
is positional (PhysCol carries an index) and display names stay readable.
"""

from __future__ import annotations

from ..errors import PlanError
from ..logical import plan as L
from ..logical.dfschema import DFSchema
from ..logical.expr import (
    AggregateFunction,
    Alias,
    Between,
    BinaryExpr,
    Case,
    Cast,
    Column,
    Exists,
    Expr,
    InList,
    InSubquery,
    IsNotNull,
    IsNull,
    Literal,
    Negative,
    Not,
    OuterColumn,
    ScalarFunction,
    ScalarSubquery,
    SortExpr,
    WindowFunction,
)
from ..exprs import physical as P
from ..ops.aggregate import HashAggregateExec, PhysAggExpr
from ..ops.base import ExecutionPlan
from ..ops.join import CrossJoinExec, HashJoinExec
from ..ops.basic import (
    EmptyExec,
    ExplainExec,
    FilterExec,
    GlobalLimitExec,
    MemoryExec,
    ProjectionExec,
    SkipExec,
    UnionExec,
)
from ..ops.sort import PhysSortExpr, SortExec
from ..ops.window import PhysWindowExpr, WindowAggExec
from ..types import Field, Schema


def _not_ported(what: str, slice_no: int) -> PlanError:
    return PlanError(f"{what} is ported in slice {slice_no}")


class PhysicalPlanner:
    def create_physical_plan(self, plan: L.LogicalPlan) -> ExecutionPlan:
        raise NotImplementedError


class DefaultPhysicalPlanner(PhysicalPlanner):
    def __init__(self, device=None, extension_planners: list | None = None):
        # the device that operators creating tables (EMPTY, VALUES,
        # EXPLAIN) put them on
        self.device = device
        if extension_planners is None:
            from .joinagg_planner import CrossJoinAggPlanner
            from .rolling_planner import RollingWindowPlanner

            extension_planners = [RollingWindowPlanner(), CrossJoinAggPlanner()]
        self.extension_planners = extension_planners

    # ==================================================================
    def create_physical_plan(self, plan: L.LogicalPlan) -> ExecutionPlan:
        t = type(plan)

        if isinstance(plan, L.TableScan):
            return plan.source.scan(
                projection=plan.projection,
                filters=plan.filters,
                limit=plan.limit,
                table_name=plan.table_name,
            )

        if isinstance(plan, L.EmptyRelation):
            return EmptyExec(plan.schema().to_schema(), plan.produce_one_row, self.device)

        if isinstance(plan, L.Values):
            return self._plan_values(plan)

        if isinstance(plan, L.Projection):
            input_exec = self.create_physical_plan(plan.input)
            in_schema = plan.input.schema()
            exprs = []
            for e, f in zip(plan.exprs, plan.schema().fields):
                pe = create_physical_expr(e, in_schema)
                exprs.append((pe, f.qualified_name))
            return ProjectionExec(exprs, input_exec)

        if isinstance(plan, L.Filter):
            input_exec = self.create_physical_plan(plan.input)
            pred = create_physical_expr(plan.predicate, plan.input.schema())
            return FilterExec(pred, input_exec)

        if isinstance(plan, L.Aggregate):
            return self._plan_aggregate(plan)

        if isinstance(plan, L.Window):
            return self._plan_window(plan)

        if isinstance(plan, L.Sort):
            input_exec = self.create_physical_plan(plan.input)
            in_schema = plan.input.schema()
            specs = [
                PhysSortExpr(
                    create_physical_expr(s.expr, in_schema), s.ascending, s.nulls_first
                )
                for s in plan.exprs
            ]
            return SortExec(specs, input_exec)

        if isinstance(plan, L.Join):
            return self._plan_join(plan)

        if isinstance(plan, L.CrossJoin):
            return CrossJoinExec(
                self.create_physical_plan(plan.left),
                self.create_physical_plan(plan.right),
            )

        if isinstance(plan, L.Union):
            target = Schema(
                [
                    Field(f.qualified_name, f.dtype, f.nullable)
                    for f in plan.schema().fields
                ]
            )
            return UnionExec(
                [self.create_physical_plan(i) for i in plan.inputs_], target
            )

        if isinstance(plan, L.Distinct):
            input_exec = self.create_physical_plan(plan.input)
            in_schema = plan.input.schema()
            group = [
                (create_physical_expr(Column(f.name, f.qualifier), in_schema), f.qualified_name)
                for f in in_schema.fields
            ]
            return HashAggregateExec("single", group, [], input_exec)

        if isinstance(plan, L.Limit):
            return GlobalLimitExec(plan.n, self.create_physical_plan(plan.input))

        if isinstance(plan, L.Skip):
            return SkipExec(plan.n, self.create_physical_plan(plan.input))

        if isinstance(plan, L.Repartition):
            # exchange hint: single-device whole-table execution has no
            # partitions to exchange (the distributed planner and the SPMD
            # executor introduce real shuffles at stage boundaries instead)
            return self.create_physical_plan(plan.input)

        if isinstance(plan, L.SubqueryAlias):
            input_exec = self.create_physical_plan(plan.input)
            out_names = [f.qualified_name for f in plan.schema().fields]
            in_schema = plan.input.schema()
            exprs = [
                (create_physical_expr(Column(f.name, f.qualifier), in_schema), n)
                for f, n in zip(in_schema.fields, out_names)
            ]
            return ProjectionExec(exprs, input_exec)

        if isinstance(plan, L.Explain):
            rows = [("logical_plan", plan.plan.display())]
            try:
                phys = self.create_physical_plan(plan.plan)
                rows.append(("physical_plan", phys.display()))
                if plan.analyze:
                    # EXPLAIN ANALYZE: run the plan and report SQLMetrics
                    # (context.rs:449-476 + plan_metrics, mod.rs:322)
                    from ..ops.base import collect_plan_metrics
                    import time as _time

                    t0 = _time.perf_counter()
                    out = phys.execute()
                    elapsed = _time.perf_counter() - t0
                    metrics = collect_plan_metrics(phys)
                    lines = [f"output_rows: {out.nrows}", f"elapsed_s: {elapsed:.6f}"]
                    for k in sorted(metrics):
                        lines.append(f"{k}: {metrics[k]}")
                    rows.append(("metrics", "\n".join(lines)))
            except Exception as e:  # pragma: no cover
                rows.append(("physical_plan_error", str(e)))
            return ExplainExec(plan.schema().to_schema(), rows, self.device)

        if isinstance(plan, L.Extension):
            for ep in self.extension_planners:
                out = ep.plan_extension(plan.node, self)
                if out is not None:
                    return out
            raise PlanError(f"no extension planner for {plan.node}")

        raise PlanError(f"cannot plan {t.__name__}")

    # ==================================================================
    def _plan_values(self, plan: L.Values) -> ExecutionPlan:
        from ..columnar.table import Table

        cols: dict[str, list] = {}
        schema = plan.schema()
        for j, f in enumerate(schema.fields):
            vals = []
            for row in plan.values:
                e = row[j]
                if isinstance(e, Literal):
                    vals.append(e.value.value)
                else:
                    raise PlanError("VALUES rows must be literals")
            cols[f.qualified_name] = vals
        t = Table.from_pydict(
            cols,
            dtypes={f.qualified_name: f.dtype for f in schema.fields},
            device=self.device,
        )
        return MemoryExec(t, t.schema())

    def _plan_join(self, plan: L.Join) -> ExecutionPlan:
        left_exec = self.create_physical_plan(plan.left)
        right_exec = self.create_physical_plan(plan.right)
        ls = plan.left.schema()
        rs = plan.right.schema()
        on = [
            (create_physical_expr(l, ls), create_physical_expr(r, rs))
            for l, r in plan.on
        ]
        filt = None
        if plan.filter is not None:
            filt = create_physical_expr(plan.filter, ls.join(rs))
        return HashJoinExec(left_exec, right_exec, on, plan.join_type, filt)

    def _plan_aggregate(self, plan: L.Aggregate) -> ExecutionPlan:
        return self._aggregate_exec(
            self.create_physical_plan(plan.input), plan.input.schema(),
            plan.schema().fields, plan.group_expr, plan.aggr_expr,
        )

    def _aggregate_exec(self, input_exec, in_schema, out_fields, group_expr, aggr_expr):
        group = []
        for ge, f in zip(group_expr, out_fields[: len(group_expr)]):
            group.append((create_physical_expr(ge, in_schema), f.qualified_name))
        aggs = []
        for ae, f in zip(aggr_expr, out_fields[len(group_expr):]):
            e = ae.expr if isinstance(ae, Alias) else ae
            if not isinstance(e, AggregateFunction):
                raise PlanError(f"aggregate expr expected, got {e!r}")
            arg = (
                create_physical_expr(e.args[0], in_schema) if e.args else None
            )
            udf = getattr(e, "udf", None)
            if udf is not None:
                raise _not_ported("user-defined aggregate", 5)
            aggs.append(PhysAggExpr(e.fun, arg, f.qualified_name, e.distinct, udf))
        return HashAggregateExec("single", group, aggs, input_exec)

    def _plan_window(self, plan: L.Window) -> ExecutionPlan:
        input_exec = self.create_physical_plan(plan.input)
        in_schema = plan.input.schema()
        out_fields = plan.schema().fields
        wexprs = []
        for we, f in zip(plan.window_expr, out_fields[len(in_schema.fields):]):
            e = we.expr if isinstance(we, Alias) else we
            if not isinstance(e, WindowFunction):
                raise PlanError(f"window expr expected, got {e!r}")
            args = [create_physical_expr(a, in_schema) for a in e.args]
            pby = [create_physical_expr(p, in_schema) for p in e.partition_by]
            oby = [
                PhysSortExpr(create_physical_expr(s.expr, in_schema), s.ascending, s.nulls_first)
                for s in e.order_by
            ]
            wexprs.append(PhysWindowExpr(e.fun, args, pby, oby, f.qualified_name, f.dtype, e.frame))
        return WindowAggExec(wexprs, input_exec)


# ---------------------------------------------------------------------------
# expression binding
# ---------------------------------------------------------------------------


def create_physical_expr(e: Expr, schema: DFSchema) -> P.PhysicalExpr:
    """Bind a logical expression to column indices of the input schema
    (planner.rs create_physical_expr equivalent)."""
    if isinstance(e, Alias):
        return create_physical_expr(e.expr, schema)
    if isinstance(e, Column):
        idx = schema.index_of_column(e.name, e.relation)
        f = schema.fields[idx]
        return P.PhysCol(f.qualified_name, idx, f.dtype)
    if isinstance(e, OuterColumn):
        raise PlanError(
            f"unresolved correlated reference {e!r}: the decorrelation "
            "optimizer rule did not eliminate it"
        )
    if isinstance(e, Literal):
        return P.PhysLit(e.value)
    if isinstance(e, BinaryExpr):
        return P.PhysBinary(
            create_physical_expr(e.left, schema),
            e.op,
            create_physical_expr(e.right, schema),
            e.get_type(schema),
        )
    if isinstance(e, Not):
        return P.PhysNot(create_physical_expr(e.expr, schema))
    if isinstance(e, Negative):
        inner = create_physical_expr(e.expr, schema)
        return P.PhysNegative(inner, inner.dtype)
    if isinstance(e, IsNull):
        return P.PhysIsNull(create_physical_expr(e.expr, schema), False)
    if isinstance(e, IsNotNull):
        return P.PhysIsNull(create_physical_expr(e.expr, schema), True)
    if isinstance(e, Between):
        inner = create_physical_expr(e.expr, schema)
        lo = create_physical_expr(e.low, schema)
        hi = create_physical_expr(e.high, schema)
        from ..types.dtypes import BOOL

        ge = P.PhysBinary(inner, ">=", lo, BOOL)
        le = P.PhysBinary(inner, "<=", hi, BOOL)
        both = P.PhysBinary(ge, "and", le, BOOL)
        if e.negated:
            return P.PhysNot(both)
        return both
    if isinstance(e, Case):
        base = create_physical_expr(e.expr, schema) if e.expr is not None else None
        wt = [
            (create_physical_expr(w, schema), create_physical_expr(t, schema))
            for w, t in e.when_then
        ]
        els = (
            create_physical_expr(e.else_expr, schema)
            if e.else_expr is not None
            else None
        )
        return P.PhysCase(base, wt, els, e.get_type(schema))
    if isinstance(e, Cast):
        return P.PhysCast(create_physical_expr(e.expr, schema), e.dtype, e.safe)
    if isinstance(e, InList):
        if any(not isinstance(x, Literal) for x in e.list_):
            # rewrite as an OR chain
            from ..types.dtypes import BOOL

            out = None
            for item in e.list_:
                cmp = P.PhysBinary(
                    create_physical_expr(e.expr, schema),
                    "=",
                    create_physical_expr(item, schema),
                    BOOL,
                )
                out = cmp if out is None else P.PhysBinary(out, "or", cmp, BOOL)
            return P.PhysNot(out) if e.negated else out
        return P.PhysInList(
            create_physical_expr(e.expr, schema), [x.value for x in e.list_], e.negated
        )
    from ..logical.expr import ScalarUDFExpr

    if isinstance(e, ScalarUDFExpr):
        raise _not_ported("user-defined scalar function", 5)
    if isinstance(e, ScalarFunction):
        args = [create_physical_expr(a, schema) for a in e.args]
        return P.PhysScalarFunction(e.name, args, e.get_type(schema))
    if isinstance(e, (ScalarSubquery, InSubquery, Exists)):
        raise PlanError(
            f"subquery expression survived to physical planning: {e!r}; "
            "decorrelation failed"
        )
    if isinstance(e, SortExpr):
        return create_physical_expr(e.expr, schema)
    raise PlanError(f"cannot create physical expression for {type(e).__name__}")
