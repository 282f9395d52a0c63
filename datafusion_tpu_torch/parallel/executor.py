"""SPMD plan executor: lowers ANY physical plan onto a mesh.

Port of ``datafusion_tpu/parallel/executor.py``, the analogue of
Ballista's DistributedPlanner + executor fleet (ballista scheduler
planner.rs:40-171 stage-splits arbitrary operator trees; the executor
runs any plan).  Strategy per node:

- scans / leaves             load once, round-robin shard (the reference's
                             RoundRobinBatch repartition); a host-resident
                             table ships each shard only its own slice
- Filter / Projection        shard-local (dist_filter / dist_project)
- HashAggregate (single)     dist_aggregate: partial -> all-to-all re-key
                             by group hash -> final (planner.rs:526-601);
                             global DISTINCT places rows by the hash of the
                             DISTINCT argument first, grouped DISTINCT uses
                             dist_aggregate_exact row placement
- HashJoin (all six types)   dist_join, partitioned; small build sides
                             (<= DFTPU_BCAST_ROWS rows of capacity) take
                             the broadcast mode (CollectLeft,
                             hash_join.rs:285); hot keys escalate to the
                             skew hybrid inside dist_join; MergeJoin lowers
                             through the same path
- Sort [+ fetch]             dist_sort (range partition + local sort);
                             fetch composes dist_limit
- WindowAgg                  dist_window (PARTITION BY hash placement) or
                             dist_window_global (range placement + O(ndev)
                             corrections); ineligible shapes gather
- Union                      shard-wise concatenation
- GlobalLimit / Skip         prefix-count truncation per shard
- everything else            gather -> single-device operator -> re-shard
                             (the CoalescePartitionsExec equivalent)

``node_modes`` records (operator, mode) per plan node: "mesh"/"broadcast"
(distributed), "gather" (structurally single-partition) or
"fallback:<error>" (a distributed implementation raised ExecutionError and
the engine degraded to gather-and-run-local).  ``strict=True`` (or
DFTPU_SPMD_STRICT=1) turns those fallbacks into raises.  Only
ExecutionError is ever converted into a fallback.
"""

from __future__ import annotations

import os

import numpy as np

from ..columnar.table import Table
from ..errors import ExecutionError
from ..ops.aggregate import HashAggregateExec
from ..ops.base import ExecutionPlan
from ..ops.basic import FilterExec, GlobalLimitExec, MemoryExec, ProjectionExec, SkipExec, UnionExec
from ..ops.join import HashJoinExec
from ..ops.sort import SortExec
from ..ops.sorted import MergeJoinExec
from ..ops.window import WindowAggExec
from .mesh import ShardedTable, make_mesh
from .ops import (
    dist_aggregate,
    dist_aggregate_exact,
    dist_filter,
    dist_join,
    dist_limit,
    dist_project,
    dist_skip,
    dist_sort,
    dist_union,
    dist_window,
    dist_window_global,
    global_window_eligible,
)


class SpmdExecutor:
    """Executes a physical plan over a mesh.  ``execute_plan`` returns a
    gathered single-device Table (the collect() contract);
    ``execute_sharded`` returns the ShardedTable."""

    def __init__(self, mesh=None, n_devices: int | None = None,
                 strict: bool | None = None, analyze: bool = False):
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        if strict is None:
            strict = bool(os.environ.get("DFTPU_SPMD_STRICT"))
        self.strict = strict
        # analyze=True also records live output rows per node (one count
        # read each: EXPLAIN ANALYZE only, not the hot path)
        self.analyze = analyze
        self.node_modes: list[tuple[str, str]] = []
        # per node: exchange buckets, capacities, bytes, retries
        self.node_details: list[dict] = []

    @property
    def fallback_count(self) -> int:
        """Error-driven fallbacks (a dist op failed); 0 on a healthy mesh."""
        return sum(1 for _, m in self.node_modes if m.startswith("fallback"))

    @property
    def gather_count(self) -> int:
        """Structural gathers (single-partition-required operators)."""
        return sum(1 for _, m in self.node_modes if m == "gather")

    # ------------------------------------------------------------------
    def execute_plan(self, plan: ExecutionPlan) -> Table:
        return self._exec(plan).to_table()

    def execute_sharded(self, plan: ExecutionPlan) -> ShardedTable:
        return self._exec(plan)

    # ------------------------------------------------------------------
    def _note(self, plan, mode: str, out: ShardedTable | None = None):
        self.node_modes.append((type(plan).__name__, mode))
        d = {"op": type(plan).__name__, "mode": mode}
        if out is not None:
            d["shard_cap"] = out.shard_cap
            info = dict(out.exchange_info)
            if "op" in info:
                info["impl"] = info.pop("op")
            if "mode" in info:
                info["strategy"] = info.pop("mode")
            d.update(info)
            if self.analyze:
                d["output_rows"] = out.total_rows()
                counts = np.asarray(out.nrows.cpu(), dtype=float)
                mean = counts.sum() / max(len(counts), 1)
                d["shard_balance"] = round(float(counts.max()) / mean, 2) if mean else 1.0
        self.node_details.append(d)

    def explain_rows(self) -> str:
        """One line per executed node for mesh EXPLAIN [ANALYZE]."""
        lines = []
        for d in self.node_details:
            parts = [f"{d['op']} [{d['mode']}]"]
            for key in (
                "impl", "strategy", "output_rows", "shard_balance", "shard_cap", "bucket_cap",
                "recv_cap", "pair_cap", "retries", "exchange_bytes",
            ):
                if key in d:
                    parts.append(f"{key}={d[key]}")
            lines.append(" ".join(parts))
        return "\n".join(lines)

    def _failed(self, plan: ExecutionPlan, err: Exception, child_results):
        """A distributed implementation raised ExecutionError: strict mode
        raises; otherwise gather and run locally, recorded for EXPLAIN."""
        if self.strict:
            raise ExecutionError(
                f"strict SPMD: {type(plan).__name__} failed to lower onto the mesh: {err}"
            ) from err
        self._note(plan, f"fallback:{err}")
        return self._gather_run(plan, child_results)

    def _lowered(self, plan, children, run, mode="mesh", shrink=True):
        """``run()`` on the mesh, shrunk and noted; an ExecutionError falls
        back (``_failed``)."""
        try:
            out = run()
        except ExecutionError as e:
            return self._failed(plan, e, children)
        if shrink:
            out = out.shrink()
        self._note(plan, mode, out)
        return out

    def _exec(self, plan: ExecutionPlan) -> ShardedTable:
        if isinstance(plan, FilterExec):
            st = self._exec(plan.input)
            return self._lowered(plan, [st], lambda: dist_filter(st, plan.predicate))
        if isinstance(plan, ProjectionExec):
            st = self._exec(plan.input)
            return self._lowered(plan, [st], lambda: dist_project(st, plan.exprs), shrink=False)
        if isinstance(plan, HashAggregateExec) and plan.mode == "single":
            return self._aggregate(plan)
        if isinstance(plan, (HashJoinExec, MergeJoinExec)):
            # MergeJoinExec shares the equi-join contract; its sorted-input
            # hint has no distributed analogue, so it lowers the same way
            sl = self._exec(plan.left)
            sr = self._exec(plan.right)
            # CollectLeft for small build sides, decided from the build
            # side's static capacity bound (no host read)
            limit = int(os.environ.get("DFTPU_BCAST_ROWS", 1 << 16))
            bcast = sr.ndev * sr.shard_cap <= limit
            return self._lowered(
                plan, [sl, sr],
                lambda: dist_join(sl, sr, plan.on, plan.join_type, getattr(plan, "filter", None),
                                  broadcast=bcast),
                mode="broadcast" if bcast else "mesh",
            )
        if isinstance(plan, SortExec):
            st = self._exec(plan.input)
            out = self._lowered(plan, [st], lambda: _no_overflow(dist_sort(st, plan.sort_exprs), "dist_sort"),
                                shrink=False)
            if self.node_modes[-1][1] != "mesh":
                return out
            if plan.fetch is not None:
                # TopK: the rows are globally ordered across shards, so the
                # first `fetch` rows are each shard's prefix
                return dist_limit(out, plan.fetch).shrink()
            return out.shrink()
        if isinstance(plan, WindowAggExec):
            return self._window(plan)
        if isinstance(plan, UnionExec):
            parts = [self._exec(c) for c in plan.children()]
            return self._lowered(plan, parts, lambda: dist_union(parts, plan.schema()))
        if isinstance(plan, (GlobalLimitExec, SkipExec)):
            st = self._exec(plan.children()[0])
            op = dist_limit if isinstance(plan, GlobalLimitExec) else dist_skip
            return self._lowered(plan, [st], lambda: op(st, plan.n), shrink=False)
        if not plan.children():
            from ..datasource.host import HostMemoryExec

            if isinstance(plan, HostMemoryExec):
                # out-of-HBM scan: each shard receives only its N/ndev slice
                out = ShardedTable.from_host(plan.projected_host(), self.mesh)
                self._note(plan, "mesh", out)
                return out
            self._note(plan, "mesh")
            return ShardedTable.from_table(plan.execute(), self.mesh)
        self._note(plan, "gather")
        return self._gather_run(plan, [self._exec(c) for c in plan.children()])

    def _aggregate(self, plan: HashAggregateExec) -> ShardedTable:
        st = self._exec(plan.input)
        if any(a.distinct for a in plan.aggr_expr):
            if not plan.group_expr:
                # global DISTINCT: rows placed by the hash of the one
                # DISTINCT argument; mixed arguments have no single
                # placement, a STRUCTURAL gather
                dargs = {str(a.expr) for a in plan.aggr_expr if a.distinct}
                if len(dargs) != 1 or any(a.distinct and a.expr is None for a in plan.aggr_expr):
                    self._note(plan, "gather")
                    return self._gather_run(plan, [st])
                return self._lowered(plan, [st], lambda: dist_aggregate(st, plan.group_expr, plan.aggr_expr))
            # grouped DISTINCT needs each group's value set: place raw rows
            return self._lowered(
                plan, [st], lambda: _no_overflow(dist_aggregate_exact(st, plan), "dist_aggregate_exact")
            )
        return self._lowered(plan, [st], lambda: dist_aggregate(st, plan.group_expr, plan.aggr_expr))

    def _window(self, plan: WindowAggExec) -> ShardedTable:
        st = self._exec(plan.input)
        pkeys = [tuple(str(p) for p in w.partition_by) for w in plan.window_exprs]
        if not any(pkeys):
            # no PARTITION BY anywhere: range placement by the ORDER BY plus
            # O(ndev) corrections; ineligible shapes gather like the reference
            if not global_window_eligible(plan.window_exprs):
                self._note(plan, "gather")
                return self._gather_run(plan, [st])
            try:
                out, ovf = dist_window_global(st, plan.window_exprs)
                if ovf < 0:
                    # a RANGE value window wider than the halo (or NULL order
                    # keys): a data condition, gathered even in strict mode
                    self._note(plan, "gather")
                    return self._gather_run(plan, [st])
                _no_overflow((out, ovf), "dist_window_global")
            except ExecutionError as e:
                return self._failed(plan, e, [st])
            out = out.shrink()
            self._note(plan, "mesh", out)
            return out
        if not all(pkeys) or len(set(pkeys)) != 1:
            # mixed PARTITION BY keys: hash placement co-locates only one
            self._note(plan, "gather")
            return self._gather_run(plan, [st])
        return self._lowered(
            plan, [st], lambda: _no_overflow(dist_window(st, plan.window_exprs), "dist_window")
        )

    # ------------------------------------------------------------------
    def _gather_run(self, plan: ExecutionPlan, child_results) -> ShardedTable:
        """Gather the children to single-device Tables and run the
        operator's single-device implementation, then re-shard (the
        CoalescePartitionsExec equivalent, physical_optimizer/merge_exec.rs)."""
        children = plan.children()
        subs = [MemoryExec(c.to_table(), ch.schema()) for c, ch in zip(child_results, children)]
        node = plan.with_new_children(subs) if children else plan
        return ShardedTable.from_table(node.execute(), self.mesh)


def _no_overflow(result, what: str) -> ShardedTable:
    out, ovf = result
    if ovf > 0:
        raise ExecutionError(f"{what}: bucket overflow persists")
    return out
