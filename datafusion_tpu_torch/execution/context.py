"""ExecutionContext: the session entry point.

Port of ``datafusion_tpu/execution/context.py`` (reference:
datafusion/src/execution/context.rs:123 ExecutionContext): sql() (:172),
create_logical_plan (:214), optimize (:449), create_physical_plan (:478),
register_table, catalogs with optional information_schema, ExecutionConfig,
variable providers.  ``collect`` runs optimize -> create_physical_plan ->
execute, with a plan cache, inside a speculation window: a warm plan runs
as one unit (``physical/query_compiler.py``), and an overflow of a
speculative capacity reruns the query exactly.  File sources are ported in
slice 6.

The context owns a device: ``ExecutionContext(device=None)`` runs on the
CUDA card and raises where there is none; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable

import torch

from ..catalog.catalog import (
    MemoryCatalogProvider,
    MemorySchemaProvider,
    information_schema_columns,
    information_schema_tables,
)
from ..columnar.table import Table
from ..datasource.datasource import MemTable, TableProvider
from ..device import resolve_device
from ..errors import PlanError
from ..logical.plan import (
    CreateExternalTable,
    CreateMemoryTable,
    Explain,
    LogicalPlan,
)
from ..physical.planner import DefaultPhysicalPlanner
from ..sql.parser import parse_sql
from ..sql.planner import ContextProvider, SqlToRel, _CreateView, _DropTable, _ShowVariable


@dataclass
class ExecutionConfig:
    """Reference ExecutionConfig (context.rs:647-821)."""

    concurrency: int = 8
    batch_size: int = 1 << 20
    information_schema: bool = True
    default_catalog: str = "datafusion"
    default_schema: str = "public"
    optimizer_rules: list = dc_field(default_factory=list)
    physical_optimizer_rules: list = dc_field(default_factory=list)
    query_planner: object = None

    def with_concurrency(self, n: int) -> "ExecutionConfig":
        self.concurrency = n
        return self

    def with_batch_size(self, n: int) -> "ExecutionConfig":
        self.batch_size = n
        return self

    def with_information_schema(self, b: bool) -> "ExecutionConfig":
        self.information_schema = b
        return self


def default_optimizer_rules() -> list:
    """Default logical pipeline (mirrors context.rs:685-695's list, adapted:
    decorrelation + cross-join elimination are load-bearing here)."""
    from ..optimizer.aggregate_statistics import AggregateStatistics
    from ..optimizer.constant_folding import ConstantFolding
    from ..optimizer.decorrelate import DecorrelateSubqueries
    from ..optimizer.filter_pushdown import FilterPushDown
    from ..optimizer.fold_crossjoin_aggregate import FoldCrossJoinAggregate
    from ..optimizer.hash_build_probe_order import HashBuildProbeOrder
    from ..optimizer.join_reorder import EliminateCrossJoins
    from ..optimizer.limit_pushdown import EliminateLimit, LimitPushDown
    from ..optimizer.projection_pushdown import ProjectionPushDown
    from ..optimizer.semi_join_pushdown import PushdownSemiAnti
    from ..optimizer.simplify_expressions import SimplifyExpressions

    return [
        ConstantFolding(),
        SimplifyExpressions(),
        DecorrelateSubqueries(),
        EliminateCrossJoins(),
        # decorrelation splices subquery plans into the main tree; fold the
        # constants inside them too
        ConstantFolding(),
        SimplifyExpressions(),
        FilterPushDown(),
        # semi/anti joins (decorrelated IN/EXISTS) sink below inner joins
        # whose one side covers their probe columns: q18's HAVING semi
        # filters orders BEFORE the customer/lineitem joins
        PushdownSemiAnti(),
        ProjectionPushDown(),
        AggregateStatistics(),
        HashBuildProbeOrder(),
        EliminateLimit(),
        LimitPushDown(),
        # late: equi CrossJoin+Filter pairs have become Joins by now, so
        # what this folds is the genuinely non-equi residue
        # (fork joinagg.rs:96 FoldCrossJoinAggregate)
        FoldCrossJoinAggregate(),
    ]


class _Provider(ContextProvider):
    def __init__(self, ctx: "ExecutionContext"):
        self.ctx = ctx

    def get_table_provider(self, name: str):
        return self.ctx._resolve_table(name)

    def get_view(self, name: str):
        return self.ctx.views.get(name)

    def get_variable(self, name: str):
        for vp in self.ctx.variable_providers.values():
            v = vp(name)
            if v is not None:
                return v
        return None

    def get_function(self, name: str):
        return self.ctx.scalar_udfs.get(name.lower())

    def get_aggregate_function(self, name: str):
        return self.ctx.aggregate_udfs.get(name.lower())


class ExecutionContext:
    def __init__(self, config: ExecutionConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.config = config or ExecutionConfig()
        self.catalogs: dict[str, MemoryCatalogProvider] = {}
        cat = MemoryCatalogProvider()
        cat.register_schema(self.config.default_schema, MemorySchemaProvider())
        self.catalogs[self.config.default_catalog] = cat
        self.views: dict[str, LogicalPlan] = {}
        self.scalar_udfs: dict[str, object] = {}
        self.aggregate_udfs: dict[str, object] = {}
        self.variable_providers: dict[str, Callable] = {}
        self.variables: dict[str, str] = {
            "datafusion.execution.batch_size": str(self.config.batch_size),
            "datafusion.execution.concurrency": str(self.config.concurrency),
        }
        if not self.config.optimizer_rules:
            self.config.optimizer_rules = default_optimizer_rules()
        # physical-plan cache for repeated queries (keyed on the plan's
        # display + catalog generation; the reference re-plans every call,
        # but re-planning + re-fusing costs host time on every query)
        self._plan_cache: dict = {}
        self._catalog_version = 0

    # ---- registration (context.rs:313-386) ---------------------------------
    def _default_schema(self) -> MemorySchemaProvider:
        return self.catalogs[self.config.default_catalog].schema(
            self.config.default_schema
        )

    def register_table(self, name: str, table) -> None:
        """Register a Table (moved to the context's device) or a
        TableProvider."""
        if isinstance(table, Table):
            table = MemTable(table.to(self.device))
        if not isinstance(table, TableProvider):
            raise PlanError(f"cannot register {type(table)} as a table")
        self._default_schema().register_table(name, table)
        self._catalog_changed()

    def deregister_table(self, name: str) -> None:
        self._default_schema().deregister_table(name)
        self._catalog_changed()

    def _catalog_changed(self) -> None:
        """A new catalog version: the cached plans can no longer be hit, so
        they go, and their CUDA graphs' memory with them."""
        from ..physical import query_compiler as QC

        for phys in self._plan_cache.values():
            QC.release(phys)
        self._plan_cache.clear()
        self._catalog_version += 1

    def register_csv(self, name: str, path: str, *args, **kwargs):
        raise NotImplementedError("file sources are ported in slice 6")

    register_parquet = register_json = register_host_table = register_csv

    def register_catalog(self, name: str, catalog: MemoryCatalogProvider):
        self.catalogs[name] = catalog

    def register_udf(self, udf):
        self.scalar_udfs[udf.name] = udf

    def register_udaf(self, udaf):
        self.aggregate_udfs[udaf.name] = udaf

    def register_variable(self, kind: str, provider: Callable):
        self.variable_providers[kind] = provider

    def tables(self) -> list[str]:
        return self._default_schema().table_names()

    def table(self, name: str) -> "DataFrame":
        from .dataframe import DataFrame
        from ..logical.builder import LogicalPlanBuilder

        provider = self._resolve_table(name)
        if provider is None:
            raise PlanError(f"table '{name}' not found")
        return DataFrame(self, LogicalPlanBuilder.scan(name, provider).build())

    def _resolve_table(self, name: str):
        parts = name.split(".")
        if len(parts) == 1:
            cat, sch, tab = self.config.default_catalog, self.config.default_schema, parts[0]
        elif len(parts) == 2:
            cat, sch, tab = self.config.default_catalog, parts[0], parts[1]
        else:
            cat, sch, tab = parts[0], parts[1], parts[2]
        if sch == "information_schema" and self.config.information_schema:
            if tab == "tables":
                return information_schema_tables(self.catalogs, self.device)
            if tab == "columns":
                return information_schema_columns(self.catalogs, self.device)
            return None
        c = self.catalogs.get(cat)
        if c is None:
            return None
        s = c.schema(sch)
        if s is None:
            return None
        return s.table(tab)

    # ---- planning (context.rs:172,214,449,478) ------------------------------
    def create_logical_plan(self, sql: str) -> LogicalPlan:
        stmts = parse_sql(sql)
        if len(stmts) != 1:
            raise PlanError("expected a single SQL statement")
        return SqlToRel(_Provider(self)).statement_to_plan(stmts[0])

    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        for rule in self.config.optimizer_rules:
            plan = rule.optimize(plan)
        return plan

    def create_physical_plan(self, plan: LogicalPlan):
        planner = self.config.query_planner or DefaultPhysicalPlanner(self.device)
        if isinstance(plan, Explain) and plan.verbose:
            # EXPLAIN VERBOSE captures the plan after every optimizer rule
            # (context.rs:449-476 optimize_internal observer)
            from ..ops.basic import ExplainExec

            rows = [("initial_logical_plan", plan.plan.display())]
            cur = plan.plan
            for rule in self.config.optimizer_rules:
                cur = rule.optimize(cur)
                rows.append((f"logical_plan after {rule.name}", cur.display()))
            phys_inner = planner.create_physical_plan(cur)
            rows.append(("physical_plan", phys_inner.display()))
            return ExplainExec(plan.schema().to_schema(), rows, self.device)
        if isinstance(plan, Explain):
            # non-verbose EXPLAIN [ANALYZE]: display the FINAL physical plan
            # (incl. stage fusion by the physical optimizer rules)
            from ..ops.basic import ExplainExec

            rows = [("logical_plan", plan.plan.display())]
            phys_inner = self.create_physical_plan(plan.plan)
            rows.append(("physical_plan", phys_inner.display()))
            if plan.analyze:
                import time as _time

                from ..ops.base import collect_plan_metrics

                t0 = _time.perf_counter()
                out = phys_inner.execute()
                elapsed = _time.perf_counter() - t0
                metrics = collect_plan_metrics(phys_inner)
                lines = [f"output_rows: {out.nrows}", f"elapsed_s: {elapsed:.6f}"]
                for k in sorted(metrics):
                    lines.append(f"{k}: {metrics[k]}")
                rows.append(("metrics", "\n".join(lines)))
            return ExplainExec(plan.schema().to_schema(), rows, self.device)
        phys = planner.create_physical_plan(plan)
        rules = self.config.physical_optimizer_rules
        if not rules:
            from ..physical.dedup import DeduplicateSubtrees, ShareCommonSubtrees
            from ..physical.fuse import FuseStages
            from ..physical.sort_rules import EliminateRedundantSort, SortedAggregateRule

            rules = [
                SortedAggregateRule(),
                EliminateRedundantSort(),
                # views/CTEs used twice: merge the raw subtrees into one
                # marked instance, so that fusion fences around them ...
                ShareCommonSubtrees(),
                FuseStages(),
                # ... and merge the identical stage wrappers fusion then
                # builds, so that the shared work runs once per query
                DeduplicateSubtrees(),
            ]
        for rule in rules:
            phys = rule.optimize(phys)
        return phys

    # ---- entry point ------------------------------------------------------------
    def sql(self, sql: str) -> "DataFrame":
        from .dataframe import DataFrame

        plan = self.create_logical_plan(sql)

        # DDL executes eagerly, returning an empty frame (context.rs:172-213)
        if isinstance(plan, CreateExternalTable):
            self._execute_create_external(plan)
            return DataFrame.empty(self)
        if isinstance(plan, CreateMemoryTable):
            df = DataFrame(self, plan.input)
            self.register_table(plan.name, MemTable(df.collect()))
            return DataFrame.empty(self)
        if isinstance(plan, _CreateView):
            self.views[plan.name] = plan.plan
            return DataFrame.empty(self)
        if isinstance(plan, _DropTable):
            if plan.is_view:
                self.views.pop(plan.name, None)
            else:
                self.deregister_table(plan.name)
            return DataFrame.empty(self)
        if isinstance(plan, _ShowVariable):
            rows = {
                "name": [plan.variable],
                "setting": [self.variables.get(plan.variable, "")],
            }
            return DataFrame.from_table(self, Table.from_pydict(rows, device=self.device))
        return DataFrame(self, plan)

    def _execute_create_external(self, plan: CreateExternalTable):
        raise NotImplementedError("file sources are ported in slice 6")

    # ---- execution ------------------------------------------------------------
    def collect(self, plan: LogicalPlan) -> Table:
        display = [f.name for f in plan.schema().fields]  # pre-optimization names
        key = (plan.display(), self._catalog_version)
        phys = self._plan_cache.get(key)
        if phys is None:
            optimized = self.optimize(plan)
            phys = self.create_physical_plan(optimized)
            # volatile expressions must not freeze (now() is folded per query)
            if "now()" not in key[0] and len(self._plan_cache) < 256:
                self._plan_cache[key] = phys
        from ..physical import query_compiler as QC

        try:
            out = _run(phys)
        except torch.cuda.OutOfMemoryError:
            # the CUDA graphs' pool may hold what this run needs: free it
            # (later collects capture again) and run once more
            if not QC.release_graphs():
                raise
            out = _run(phys)
        # final output uses unqualified display names (keep the row count
        # lazy: callers sync once when they read data)
        if len(display) == len(out.names):
            out = Table(display, out.columns, out.nrows_dev, device=out.device)
        return out


def _run(phys) -> Table:
    """A physical plan's result inside a speculation window: a warm plan
    runs as one unit (a CUDA graph on the card); a cold one, or one with a
    node that reads the host, runs node by node, learning capacities as it
    goes.  When a speculatively sized join or stage overflowed, the plan
    reruns exactly, which relearns its capacities (a graph baked the old
    ones, so it is dropped)."""
    from ..ops import kernels as K
    from ..physical import query_compiler as QC

    with K.spec_window() as w:
        out = QC.try_whole_query(phys)
        if out is None:
            out = phys.execute()
    if w.overflowed():
        QC.invalidate(phys)
        with K.spec_exact():
            out = phys.execute()
    return out
