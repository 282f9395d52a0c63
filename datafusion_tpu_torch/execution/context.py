"""ExecutionContext: the session entry point.

Port of ``datafusion_tpu/execution/context.py`` (reference:
datafusion/src/execution/context.rs:123 ExecutionContext): sql() (:172),
create_logical_plan (:214), optimize (:449), create_physical_plan (:478),
register_table, catalogs with optional information_schema, ExecutionConfig,
variable providers.  ``collect`` runs optimize -> create_physical_plan ->
execute, with a plan cache, inside a speculation window: a warm plan runs
as one unit (``physical/query_compiler.py``), and an overflow of a
speculative capacity reruns the query exactly.  Tables come from device
Tables, host-resident tables streamed in morsels (``register_host_table``,
datasource/host.py) and files (``register_csv``/``_parquet``/``_json``,
``CREATE EXTERNAL TABLE``, datasource/files.py); results go out through
``write_csv``/``write_parquet``.

The context owns a device: ``ExecutionContext(device=None)`` runs on the
CUDA card and raises where there is none; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable

import torch

from .. import tracing
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
        """Register a Table (moved to the context's device), a HostTable
        (kept in host memory for the context's device, streamed in
        morsels) or a TableProvider."""
        from ..datasource.host import HostTable, HostTableProvider

        if isinstance(table, Table):
            table = MemTable(table.to(self.device))
        elif isinstance(table, HostTable):
            table = HostTableProvider(table.to(self.device))
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

    def register_host_table(self, name: str, table, morsel_rows: int | None = None) -> None:
        """Register a host-resident table: scans stream fixed-capacity
        morsels through fused stages, so the table never has to fit on the
        device (the reference's streamed scans, parquet.rs:596-636).  A
        device Table is copied to host memory first; on the card the host
        columns are pinned once, here."""
        from ..datasource.host import HostTable, HostTableProvider

        if isinstance(table, Table):
            table = HostTable.from_table(table)
        if not isinstance(table, HostTable):
            raise PlanError(f"cannot register {type(table)} as a host table")
        table = table.to(self.device)
        if morsel_rows is not None:
            table.morsel_rows = int(morsel_rows)
        self._default_schema().register_table(name, HostTableProvider(table))
        self._catalog_changed()

    def register_csv(self, name: str, path: str, schema=None, has_header: bool = True,
                     delimiter: str = ","):
        """A CSV (or ``|``-delimited TBL) file or directory.  With a schema
        the native loader reads it, without pyarrow."""
        from ..datasource.files import CsvFile

        self.register_table(name, CsvFile(path, schema, has_header, delimiter, device=self.device))

    def register_parquet(self, name: str, path: str, host_resident: bool = False,
                         morsel_rows: int | None = None):
        """A Parquet file or directory, on the device; ``host_resident`` (or
        ``morsel_rows``) keeps its columns in host memory and streams
        morsels instead, for a table larger than the device's memory."""
        if host_resident or morsel_rows is not None:
            from ..datasource.host import HostTable

            self.register_host_table(name, HostTable.from_parquet(path, device=self.device),
                                     morsel_rows=morsel_rows)
            return
        from ..datasource.files import ParquetTable

        self.register_table(name, ParquetTable(path, device=self.device))

    def register_json(self, name: str, path: str, schema=None):
        from ..datasource.files import NdJsonFile

        self.register_table(name, NdJsonFile(path, schema, device=self.device))

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
        with tracing.span("dftpu.sql.parse"):
            stmts = parse_sql(sql)
        if len(stmts) != 1:
            raise PlanError("expected a single SQL statement")
        with tracing.span("dftpu.sql.plan"):
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
        """The statement's DataFrame, carrying a new request id
        (``tracing``); DDL runs here and returns an empty one."""
        request = tracing.new_request()
        with tracing.span("dftpu.sql", request=request):
            df = self._statement(self.create_logical_plan(sql))
        df._request = request
        return df

    def _statement(self, plan: LogicalPlan) -> "DataFrame":
        from .dataframe import DataFrame

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
        ft = plan.file_type.upper()
        if ft == "CSV":
            self.register_csv(plan.name, plan.location, plan.schema_, plan.has_header)
        elif ft == "PARQUET":
            self.register_parquet(plan.name, plan.location)
        elif ft in ("NDJSON", "JSON"):
            self.register_json(plan.name, plan.location, plan.schema_)
        else:
            raise PlanError(f"unsupported file type {plan.file_type}")

    # ---- execution ------------------------------------------------------------
    def create_physical_plan_for_mesh(self, plan: LogicalPlan):
        """The raw (unfused) physical plan the SPMD executor lowers onto a
        mesh: the counterpart of Ballista distributing an arbitrary plan
        (scheduler/src/planner.rs:40-171)."""
        planner = self.config.query_planner or DefaultPhysicalPlanner(self.device)
        return planner.create_physical_plan(self.optimize(plan))

    def collect(self, plan: LogicalPlan, mesh=None, request: int | None = None) -> Table:
        """Execute ``plan``.  With ``mesh`` (``parallel.mesh.make_mesh``),
        the plan runs SPMD over the mesh (``parallel/executor.py``).  The
        result carries ``request`` (a new one when None) for its decode's
        spans (``tracing``)."""
        if request is None:
            request = tracing.new_request()
        with tracing.span("dftpu.collect", request=request):
            out = self._collect(plan, mesh)
        out.request = request
        return out

    def _collect(self, plan: LogicalPlan, mesh) -> Table:
        display = [f.name for f in plan.schema().fields]  # pre-optimization names
        if mesh is not None and not (isinstance(plan, Explain) and plan.verbose):
            return self._collect_on_mesh(plan, mesh, display)
        with tracing.span("dftpu.collect.plan"):
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

    def _collect_on_mesh(self, plan: LogicalPlan, mesh, display) -> Table:
        """collect() over a mesh; mesh EXPLAIN [ANALYZE] shows the raw plan
        and, for ANALYZE, runs it and reports each node's mode (mesh,
        broadcast, gather, fallback) and exchange statistics (the
        distributed-metrics analogue of repartition.rs:58-100)."""
        import time as _time

        from ..ops.basic import ExplainExec
        from ..parallel.executor import SpmdExecutor

        if isinstance(plan, Explain):
            rows = [("logical_plan", plan.plan.display())]
            phys_inner = self.create_physical_plan_for_mesh(plan.plan)
            rows.append(("physical_plan", phys_inner.display()))
            if plan.analyze:
                ex = SpmdExecutor(mesh, analyze=True)
                t0 = _time.perf_counter()
                out = ex.execute_plan(phys_inner)
                elapsed = _time.perf_counter() - t0
                lines = [
                    f"output_rows: {out.nrows}",
                    f"elapsed_s: {elapsed:.6f}",
                    f"devices: {mesh.devices.size}",
                    f"error_fallbacks: {ex.fallback_count}",
                    f"structural_gathers: {ex.gather_count}",
                ]
                rows.append(("mesh_metrics", "\n".join(lines)))
                rows.append(("mesh_plan", ex.explain_rows()))
            return ExplainExec(plan.schema().to_schema(), rows, self.device).execute()
        phys = self.create_physical_plan_for_mesh(plan)
        out = SpmdExecutor(mesh).execute_plan(phys)
        if len(display) == len(out.names):
            out = Table(display, out.columns, out.nrows_dev, device=out.device)
        return out

    # ---- output (context.rs:492,530) ------------------------------------------
    def write_csv(self, df, path: str):
        import pyarrow.csv as pacsv

        pacsv.write_csv(df.collect().to_arrow(), path)

    def write_parquet(self, df, path: str):
        import pyarrow.parquet as pq

        pq.write_table(df.collect().to_arrow(), path)


def _run(phys) -> Table:
    """A physical plan's result inside a speculation window: a warm plan
    runs as one unit (a CUDA graph on the card); a cold one, or one with a
    node that reads the host, runs node by node, learning capacities as it
    goes.  When a speculatively sized join or stage overflowed, the plan
    reruns exactly, which relearns its capacities (a graph baked the old
    ones, so it is dropped)."""
    from ..ops import kernels as K
    from ..physical import query_compiler as QC

    with tracing.span("dftpu.collect.run"):
        with K.spec_window() as w:
            out = QC.try_whole_query(phys)
            whole = out is not None
            if not whole:
                out = phys.execute()
        tracing.count("dftpu.collect.whole" if whole else "dftpu.collect.eager")
        if w.overflowed():
            tracing.count("dftpu.collect.rerun")
            QC.invalidate(phys)
            with K.spec_exact():
                out = phys.execute()
    return out
