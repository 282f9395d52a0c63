"""DataFrame: lazy relational builder over a LogicalPlan.

Port of ``datafusion_tpu/execution/dataframe.py`` (reference:
datafusion/src/dataframe.rs + execution/dataframe_impl.rs:143):
select/filter/aggregate/join/sort/limit/union/distinct/explain, terminal
collect()/show()/to_arrow() and write_csv()/write_parquet().
"""

from __future__ import annotations

from ..columnar.table import Table
from ..logical.builder import LogicalPlanBuilder
from ..logical.dfschema import DFSchema
from ..logical.expr import Column, Expr
from ..logical.plan import EmptyRelation, Explain, LogicalPlan


class DataFrame:
    def __init__(self, ctx, plan: LogicalPlan):
        self._ctx = ctx
        self._plan = plan
        # the request (``tracing``) of the ``ctx.sql`` call that made it
        self._request = None

    # ---- constructors ---------------------------------------------------------
    @staticmethod
    def empty(ctx) -> "DataFrame":
        return DataFrame(ctx, EmptyRelation(False, DFSchema.empty()))

    @staticmethod
    def from_table(ctx, table: Table) -> "DataFrame":
        from ..datasource.datasource import MemTable

        provider = MemTable(table.to(ctx.device))
        return DataFrame(
            ctx, LogicalPlanBuilder.scan("memory", provider).build()
        )

    # ---- builders (dataframe.rs API) -------------------------------------------
    def _b(self) -> LogicalPlanBuilder:
        return LogicalPlanBuilder(self._plan)

    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*[Column(n) for n in names])

    def select(self, *exprs: Expr) -> "DataFrame":
        return DataFrame(self._ctx, self._b().project(list(exprs)).build())

    def filter(self, predicate: Expr) -> "DataFrame":
        return DataFrame(self._ctx, self._b().filter(predicate).build())

    def aggregate(self, group_expr: list[Expr], aggr_expr: list[Expr]) -> "DataFrame":
        return DataFrame(
            self._ctx, self._b().aggregate(group_expr, aggr_expr).build()
        )

    def window(self, window_exprs: list[Expr]) -> "DataFrame":
        return DataFrame(self._ctx, self._b().window(window_exprs).build())

    def sort(self, *exprs) -> "DataFrame":
        return DataFrame(self._ctx, self._b().sort(list(exprs)).build())

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._ctx, self._b().limit(n).build())

    def skip(self, n: int) -> "DataFrame":
        return DataFrame(self._ctx, self._b().skip(n).build())

    def distinct(self) -> "DataFrame":
        return DataFrame(self._ctx, self._b().distinct().build())

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._ctx, self._b().union(other._plan).build())

    def join(
        self,
        right: "DataFrame",
        left_cols: list[str],
        right_cols: list[str],
        join_type: str = "inner",
    ) -> "DataFrame":
        on = [
            (Column(l), Column(r)) for l, r in zip(left_cols, right_cols)
        ]
        return DataFrame(
            self._ctx, self._b().join(right._plan, join_type, on).build()
        )

    def cross_join(self, right: "DataFrame") -> "DataFrame":
        return DataFrame(self._ctx, self._b().cross_join(right._plan).build())

    def repartition(self, n: int, *exprs: Expr) -> "DataFrame":
        """Exchange hint (dataframe.rs repartition): round-robin without
        exprs, hash-partitioned on exprs with.  Single-device execution
        ignores it; the distributed planner and SPMD executor realize it
        as shuffle boundaries."""
        part = "hash" if exprs else "round_robin"
        return DataFrame(
            self._ctx, self._b().repartition(part, n, list(exprs)).build()
        )

    def alias(self, name: str) -> "DataFrame":
        return DataFrame(self._ctx, self._b().alias(name).build())

    def explain(self, verbose: bool = False) -> "DataFrame":
        return DataFrame(self._ctx, Explain(self._plan, verbose))

    # ---- introspection -----------------------------------------------------------
    def schema(self) -> DFSchema:
        return self._plan.schema()

    def logical_plan(self) -> LogicalPlan:
        return self._plan

    def to_logical_plan(self) -> LogicalPlan:
        return self._ctx.optimize(self._plan)

    # ---- terminals -------------------------------------------------------------------
    def collect(self, mesh=None) -> Table:
        """Execute the plan on the context's device, or with ``mesh``
        (``parallel.mesh.make_mesh``) SPMD over the mesh."""
        return self._ctx.collect(self._plan, mesh=mesh, request=self._request)

    def collect_partitioned(self, mesh=None) -> list[Table]:
        """Per-partition results (dataframe.rs collect_partitioned): with a
        mesh, one Table per shard; a single device returns one partition."""
        if mesh is None:
            return [self.collect()]
        from ..parallel.executor import SpmdExecutor

        phys = self._ctx.create_physical_plan_for_mesh(self._plan)
        parts = SpmdExecutor(mesh).execute_sharded(phys).shard_tables()
        display = [f.name for f in self._plan.schema().fields]
        return [
            Table(display, p.columns, p.nrows_dev, device=p.device) if len(display) == len(p.names) else p
            for p in parts
        ]

    def to_pandas(self):
        return self.collect().to_pandas()

    def to_arrow(self):
        return self.collect().to_arrow()

    def to_pydict(self) -> dict:
        return self.collect().to_pydict()

    def count(self) -> int:
        return self.collect().nrows

    def show(self, n: int = 20):
        print(self.limit(n).to_pandas().to_string(index=False))

    def write_csv(self, path: str):
        self._ctx.write_csv(self, path)

    def write_parquet(self, path: str):
        self._ctx.write_parquet(self, path)
