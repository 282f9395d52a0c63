"""DistributedPlanner: split a physical plan into a shuffle-stage DAG.

Port of ``datafusion_tpu/distributed/planner.py`` (host logic over the
port's operators).  Equivalent of Ballista's DistributedPlanner
(ballista/rust/scheduler/src/planner.rs:40-171): walk the physical plan
and cut it at exchange boundaries --

  * grouped aggregate:  Partial (partition-wise) | hash shuffle on group
    keys | Final (partition-wise on the re-keyed data), DataFusion's
    Partial -> RepartitionExec(Hash) -> FinalPartitioned split
    (physical_plan/planner.rs:526-601)
  * no-group aggregate: Partial | coalesce | Final(single)
  * equi-join:          hash-shuffle BOTH inputs on their key exprs so
    matching keys co-locate, then join partition-wise
    (planner.rs:753-851 repartition_joins path)
  * sort / limit / offset / window / union / cross join: coalesce to a
    single partition (AddCoalescePartitionsExec, physical_optimizer/
    merge_exec.rs)

Each cut becomes a QueryStage whose plan is a ShuffleWriterExec template;
downstream nodes read it through UnresolvedShuffleExec placeholders that
the scheduler resolves to ShuffleReaderExec once the stage completes
(planner.rs:179 remove_unresolved_shuffles).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..errors import PlanError
from ..exprs.physical import PhysCol
from ..ops.aggregate import HashAggregateExec
from ..ops.base import ExecutionPlan
from ..ops.basic import (
    EmptyExec,
    FilterExec,
    GlobalLimitExec,
    MemoryExec,
    ProjectionExec,
    SkipExec,
    UnionExec,
)
from ..ops.join import CrossJoinExec, HashJoinExec
from ..ops.sort import SortExec
from ..ops.window import WindowAggExec
from .exchange import (
    DistScanExec,
    ShuffleWriterExec,
    UnresolvedShuffleExec,
)


@dataclass
class QueryStage:
    """One shuffle stage (ballista QueryStageExec equivalent)."""

    stage_id: int
    plan: ShuffleWriterExec  # template; input_partition bound per task
    num_input_partitions: int
    num_output_partitions: int
    dependencies: list[int] = field(default_factory=list)


class DistributedPlanner:
    def __init__(self, target_partitions: int = 4):
        self.target_partitions = target_partitions

    # ------------------------------------------------------------------
    def plan_query_stages(
        self, job_id: str, plan: ExecutionPlan
    ) -> tuple[list[QueryStage], QueryStage]:
        """Returns (all stages in dependency order, final stage)."""
        self._job_id = job_id
        self._next_stage = 0
        self._stages: list[QueryStage] = []
        root, n_parts = self._walk(plan)
        final = self._make_stage(root, n_parts, partition_exprs=None, coalesce_per_input=True)
        return self._stages, final

    # ------------------------------------------------------------------
    def _make_stage(
        self,
        plan: ExecutionPlan,
        num_input_partitions: int,
        partition_exprs,
        num_output_partitions: int | None = None,
        coalesce_per_input: bool = False,
    ) -> QueryStage:
        sid = self._next_stage
        self._next_stage += 1
        if partition_exprs is None:
            m = 1
        else:
            m = num_output_partitions or self.target_partitions
        writer = ShuffleWriterExec(
            self._job_id, sid, plan, partition_exprs, m
        )
        deps = sorted({u.stage_id for u in _find_unresolved(plan)})
        stage = QueryStage(sid, writer, num_input_partitions, m, deps)
        self._stages.append(stage)
        return stage

    def _shuffle_boundary(
        self, plan: ExecutionPlan, n_parts: int, partition_exprs
    ) -> tuple[UnresolvedShuffleExec, int]:
        """Cut here: stage writes hash partitions; downstream reads M."""
        stage = self._make_stage(plan, n_parts, partition_exprs)
        return (
            UnresolvedShuffleExec(stage.stage_id, plan.schema(), stage.num_output_partitions),
            stage.num_output_partitions,
        )

    def _coalesce(self, plan: ExecutionPlan, n_parts: int):
        """Ensure a single partition downstream of `plan`."""
        if n_parts == 1:
            return plan, 1
        stage = self._make_stage(plan, n_parts, partition_exprs=None)
        return UnresolvedShuffleExec(stage.stage_id, plan.schema(), 1), 1

    # ------------------------------------------------------------------
    def _walk(self, p: ExecutionPlan) -> tuple[ExecutionPlan, int]:
        if isinstance(p, DistScanExec):
            return p, p.num_partitions
        if isinstance(p, MemoryExec):
            if not p.table_name:
                # inline data (VALUES, cached file scans): single partition
                raise PlanError(
                    "distributed planning requires named table scans; "
                    f"got anonymous MemoryExec ({p._display_line()})"
                )
            return (
                DistScanExec(
                    p.table_name, p._schema, p.projection, self.target_partitions
                ),
                self.target_partitions,
            )
        if isinstance(p, EmptyExec):
            return p, 1

        if isinstance(p, (ProjectionExec, FilterExec)):
            child, n = self._walk(p.children()[0])
            return p.with_new_children([child]), n

        if isinstance(p, HashAggregateExec) and p.mode == "single":
            child, n = self._walk(p.input)
            if n == 1:
                return p.with_new_children([child]), 1
            distinct_aggs = [a for a in p.aggr_expr if a.distinct]
            if distinct_aggs:
                # distinct states cannot ship as scalars (per-partition
                # dedup over-counts cross-partition repeats): the partial
                # groups by (keys + distinct value exprs) and ships the
                # dedup'd PAIRS; shuffling by the ORIGINAL keys co-locates
                # each group's values so the final re-dedups exactly
                pgroup = list(p.group_expr) + [
                    (a.expr, f"__dv{i}") for i, a in enumerate(distinct_aggs)
                ]
                paggs = [a for a in p.aggr_expr if not a.distinct]
                partial = HashAggregateExec("partial", pgroup, paggs, child)
            else:
                partial = HashAggregateExec(
                    "partial", p.group_expr, p.aggr_expr, child
                )
            pschema = partial.schema()
            if p.group_expr:
                keys = [
                    PhysCol(pschema.fields[i].name, i, pschema.fields[i].dtype)
                    for i in range(len(p.group_expr))
                ]
                reader, m = self._shuffle_boundary(partial, n, keys)
            else:
                reader, m = self._coalesce(partial, n)
            final_group = [
                (PhysCol(pschema.fields[i].name, i, pschema.fields[i].dtype), name)
                for i, (_, name) in enumerate(p.group_expr)
            ]
            return (
                HashAggregateExec(
                    "final",
                    final_group,
                    p.aggr_expr,
                    reader,
                    distinct_values=len(distinct_aggs),
                ),
                m,
            )

        if isinstance(p, HashJoinExec):
            left, ln = self._walk(p.left)
            right, rn = self._walk(p.right)
            if ln == 1 and rn == 1:
                return p.with_new_children([left, right]), 1
            if not p.on:
                left, _ = self._coalesce(left, ln)
                right, _ = self._coalesce(right, rn)
                return p.with_new_children([left, right]), 1
            # broadcast mode (PartitionMode::CollectLeft, hash_join.rs:285):
            # a single-partition build side is read whole by every probe
            # task — the big probe side never shuffles.  Valid when
            # unmatched-build rows are not emitted per partition.
            if rn == 1 and ln > 1 and p.join_type in ("inner", "left", "semi", "anti"):
                return p.with_new_children([left, right]), ln
            if ln == 1 and rn > 1 and p.join_type == "inner":
                return p.with_new_children([left, right]), rn
            lkeys = [l for l, _ in p.on]
            rkeys = [r for _, r in p.on]
            lreader, m = self._shuffle_boundary(left, ln, lkeys)
            rreader, _ = self._shuffle_boundary(right, rn, rkeys)
            return p.with_new_children([lreader, rreader]), m

        if isinstance(p, (CrossJoinExec,)):
            left, ln = self._walk(p.left)
            right, rn = self._walk(p.right)
            left, _ = self._coalesce(left, ln)
            right, _ = self._coalesce(right, rn)
            return p.with_new_children([left, right]), 1

        if isinstance(p, UnionExec):
            new_inputs = []
            for c in p.inputs:
                cc, cn = self._walk(c)
                cc, _ = self._coalesce(cc, cn)
                new_inputs.append(cc)
            return p.with_new_children(new_inputs), 1

        if isinstance(p, GlobalLimitExec):
            # LocalLimitExec pattern (limit.rs:146): push a per-partition
            # limit (TopK when sorted) into the producing stage so only
            # n rows per partition cross the shuffle
            inner = p.input
            if isinstance(inner, SortExec):
                child, n = self._walk(inner.input)
                if n > 1:
                    local = SortExec(inner.sort_exprs, child, fetch=p.n)
                    reader, _ = self._coalesce(local, n)
                    merged = SortExec(inner.sort_exprs, reader, inner.fetch)
                    return GlobalLimitExec(p.n, merged), 1
                return p.with_new_children([inner.with_new_children([child])]), 1
            child, n = self._walk(inner)
            if n > 1:
                local = GlobalLimitExec(p.n, child)
                reader, _ = self._coalesce(local, n)
                return GlobalLimitExec(p.n, reader), 1
            return p.with_new_children([child]), 1

        if isinstance(p, (SortExec, SkipExec, WindowAggExec)):
            child, n = self._walk(p.children()[0])
            child, _ = self._coalesce(child, n)
            return p.with_new_children([child]), 1

        if isinstance(p, HashAggregateExec):  # partial/final built upstream
            child, n = self._walk(p.input)
            return p.with_new_children([child]), n

        # unknown operator: run it single-partition (safe fallback)
        children = p.children()
        if not children:
            return p, 1
        new_children = []
        for c in children:
            cc, cn = self._walk(c)
            cc, _ = self._coalesce(cc, cn)
            new_children.append(cc)
        return p.with_new_children(new_children), 1


def _find_unresolved(plan: ExecutionPlan) -> list[UnresolvedShuffleExec]:
    out = []
    if isinstance(plan, UnresolvedShuffleExec):
        out.append(plan)
    for c in plan.children():
        out.extend(_find_unresolved(c))
    return out


def remove_unresolved_shuffles(
    plan: ExecutionPlan,
    partition: int,
    stage_info: dict[int, dict],
    work_dir: str,
    job_id: str,
) -> ExecutionPlan:
    """Swap UnresolvedShuffleExec for concrete ShuffleReaderExec reading the
    completed stage's files for this task's partition
    (scheduler/src/planner.rs:179)."""
    from .exchange import ShuffleReaderExec, ShuffleWriterExec

    if isinstance(plan, UnresolvedShuffleExec):
        info = stage_info[plan.stage_id]
        nin = info["num_input_partitions"]
        # hash stage: read our output-partition file from every input
        # partition; coalesce stage (1 output): same with out=0
        out_p = partition if info["num_output_partitions"] > 1 else 0
        paths = [
            ShuffleWriterExec.file_path(work_dir, job_id, plan.stage_id, i, out_p)
            for i in range(nin)
        ]
        return ShuffleReaderExec(paths, plan._schema)
    kids = plan.children()
    if not kids:
        return plan
    return plan.with_new_children(
        [
            remove_unresolved_shuffles(c, partition, stage_info, work_dir, job_id)
            for c in kids
        ]
    )


def bind_scan_partition(plan: ExecutionPlan, partition: int, store) -> None:
    """Bind DistScanExec leaves to this task's input partition + the
    executor's table store (in place; plans are per-task deserialized)."""
    if isinstance(plan, DistScanExec):
        plan.partition = partition
        plan.store = store
    for c in plan.children():
        bind_scan_partition(c, partition, store)
