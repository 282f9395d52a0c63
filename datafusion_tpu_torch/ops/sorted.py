"""Sorted-path operators (the CubeStore fork's merge family).

Port of ``datafusion_tpu/ops/sorted.py``.  Reference equivalents:
  MergeSortExec            merge_sort.rs:52   k-way merge of sorted inputs
  MergeReSortExec          merge_sort.rs:141  sort each input, then merge
  SortPreservingMergeExec  sort_preserving_merge.rs:55 (upstream twin)
  LastRowByUniqueKeyExec   merge_sort.rs:562  keep-last dedup of sorted rows
  SortedAggregateExec      sorted_aggregate.rs:41 group-by over input
                           sorted on its keys (InplaceSorted,
                           planner.rs:1667 compute_aggregation_strategy)
  MergeJoinExec            merge_join.rs:48   sort-merge equi-join
                           (inner/left/right only, merge_join.rs:404-408)

The reference's cursor loops become data-parallel steps.  A k-way merge is
a concatenation and one stable sort, and its value is the preserved
``output_sort_order()`` that lets the sort rules (physical/sort_rules.py)
drop later sorts.  SortedAggregateExec is the sort-path GROUP BY without
its sort: group ids from a neighbour compare and a prefix sum, then the
same segment reductions (``ops/aggregate.py``).  MergeJoinExec keeps the
sorted plan's shape and pairs rows with the hash join's machinery.  No
operator reads a count on the host: LastRowByUniqueKeyExec keeps its count
on the device, and SortedAggregateExec learns its output capacity as the
fused stages do.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..columnar.table import Table
from ..errors import InternalError
from ..types import Schema
from . import kernels as K
from .aggregate import HashAggregateExec, output_columns, segment_aggregate
from .base import ExecutionPlan
from .basic import concat_tables
from .sort import PhysSortExpr, sort_table


class MergeSortExec(ExecutionPlan):
    """Merge k sorted inputs into one sorted output (merge_sort.rs:52)."""

    def __init__(self, inputs: list[ExecutionPlan], sort_exprs: list[PhysSortExpr]):
        super().__init__()
        if not inputs:
            raise InternalError("MergeSortExec needs >= 1 input")
        self.inputs = inputs
        self.sort_exprs = sort_exprs

    def schema(self) -> Schema:
        return self.inputs[0].schema()

    def children(self):
        return list(self.inputs)

    def with_new_children(self, c):
        return type(self)(list(c), self.sort_exprs)

    def output_sort_order(self):
        from ..exprs.physical import PhysCol

        out = []
        for s in self.sort_exprs:
            if not isinstance(s.expr, PhysCol):
                return None
            out.append((s.expr.index, s.ascending, s.nulls_first))
        return out

    def _execute(self) -> Table:
        tables = [i.execute() for i in self.inputs]
        if len(tables) == 1:
            return tables[0]
        # the merge: one stable sort over the concatenated runs
        return sort_table(concat_tables(tables, self.schema()), self.sort_exprs)

    def _display_line(self):
        return f"{type(self).__name__}: {self.sort_exprs} x{len(self.inputs)}"


class MergeReSortExec(MergeSortExec):
    """Sort each input first, then merge (merge_sort.rs:141).  The
    concatenation's one sort subsumes the per-input sorts, so it runs as
    MergeSortExec; the class keeps the plan's shape."""


class SortPreservingMergeExec(MergeSortExec):
    """Upstream heap-merge twin (sort_preserving_merge.rs:55)."""


class LastRowByUniqueKeyExec(ExecutionPlan):
    """Keep the LAST row of each consecutive unique-key run
    (merge_sort.rs:562; the input is sorted by the key columns)."""

    def __init__(self, input: ExecutionPlan, key_indices: list[int]):
        super().__init__()
        self.input = input
        self.key_indices = key_indices

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return LastRowByUniqueKeyExec(c[0], self.key_indices)

    def output_sort_order(self):
        return self.input.output_sort_order()

    def _execute(self) -> Table:
        t = self.input.execute()
        cap = t.capacity
        ar = torch.arange(cap, device=t.device)
        alive = ar < t.nrows_dev
        is_last = torch.ones(cap, dtype=torch.bool, device=t.device)
        for ki in self.key_indices:
            c = t.columns[ki]
            d = K.signed_view(c.data)
            same = (d == torch.roll(d, -1)) & (c.valid == torch.roll(c.valid, -1))
            is_last = is_last & ~same
        # the last live row always ends its run
        is_last = is_last | (ar == torch.where(alive, ar, -1).max())
        d2, v2, n = K.filter_compact(
            tuple(c.data for c in t.columns), tuple(c.valid for c in t.columns),
            alive & is_last, t.nrows_dev,
        )
        cols = [Column(c.dtype, d, v, c.dictionary) for c, d, v in zip(t.columns, d2, v2)]
        self.lazy_metric("dedup_dropped", t.nrows_dev - n)
        return Table(list(t.names), cols, n, device=t.device)

    def _display_line(self):
        return f"LastRowByUniqueKeyExec: keys={self.key_indices}"


class SortedAggregateExec(ExecutionPlan):
    """GROUP BY over input already sorted on the group keys
    (sorted_aggregate.rs:41, AggregateStrategy::InplaceSorted).

    No sort: a group starts where any key's data or validity differs from
    the row before; the group ids are the prefix sum of those starts."""

    def __init__(self, mode: str, group_expr, aggr_expr, input: ExecutionPlan):
        super().__init__()
        self.mode = mode
        self.group_expr = group_expr
        self.aggr_expr = aggr_expr
        self.input = input
        # the schema is the hash strategy's
        self._hash_twin = HashAggregateExec(mode, group_expr, aggr_expr, input)
        self._learned: dict = {}  # output capacity per input signature

    def schema(self) -> Schema:
        return self._hash_twin.schema()

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return SortedAggregateExec(self.mode, self.group_expr, self.aggr_expr, c[0])

    def output_sort_order(self):
        return None  # groups leave in input order; stated conservatively

    def _execute(self) -> Table:
        t = self.input.execute()
        cap, dev = t.capacity, t.device
        ar = torch.arange(cap, device=dev)
        alive = ar < t.nrows_dev
        key_cols = [e.evaluate(t) for e, _ in self.group_expr]
        boundary = torch.zeros(cap, dtype=torch.bool, device=dev)
        for c in key_cols:
            boundary = K._boundary_accum(boundary, K.signed_view(c.data), c.valid)
        boundary[:1].fill_(True)
        boundary = boundary & alive
        ngroups = boundary.sum()
        gid = torch.where(alive, torch.cumsum(boundary, 0) - 1, cap - 1)
        seg = K.segments(gid)
        gv = ar < ngroups
        out_cols = [
            Column(kc.dtype, K.gather(kc.data, seg.first), kc.valid[seg.first] & gv, kc.dictionary)
            for kc in key_cols
        ]
        for a in self.aggr_expr:
            out_cols += segment_aggregate(a, t, None, seg, cap, alive, ngroups,
                                          emit_state=self.mode == "partial")
        names, _, _ = output_columns(self, t, key_cols)
        out = Table(names, out_cols, ngroups, device=dev)
        sig = (cap, tuple(str(c.dtype) for c in t.columns))
        return K.fit_learned(out, self._learned, sig)

    def _display_line(self):
        return (
            f"SortedAggregateExec[{self.mode}]: "
            f"group={[n for _, n in self.group_expr]}, aggr={self.aggr_expr}"
        )


class MergeJoinExec(ExecutionPlan):
    """Sort-merge equi-join over inputs sorted by the join keys
    (merge_join.rs:48; inner/left/right only, :404-408).  The pairing is
    the hash join's (``join_tables``): with sorted inputs both strategies
    are one gather apart, and sharing it keeps the semantics identical; the
    operator keeps the sorted plan's shape."""

    JOIN_TYPES = ("inner", "left", "right")

    def __init__(self, left, right, on, join_type: str = "inner"):
        super().__init__()
        if join_type not in self.JOIN_TYPES:
            raise InternalError(f"MergeJoin supports {self.JOIN_TYPES}")
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type

    def schema(self) -> Schema:
        return Schema(list(self.left.schema().fields) + list(self.right.schema().fields))

    def children(self):
        return [self.left, self.right]

    def with_new_children(self, c):
        return MergeJoinExec(c[0], c[1], self.on, self.join_type)

    def output_sort_order(self):
        return None  # the expansion interleaves matches; stated conservatively

    def _execute(self) -> Table:
        from .join import join_tables

        return join_tables(self.left.execute(), self.right.execute(), self.on,
                           self.join_type, None, self.metrics)

    def _display_line(self):
        on = ", ".join(f"{l!r}={r!r}" for l, r in self.on)
        return f"MergeJoinExec[{self.join_type}]: on=[{on}]"
