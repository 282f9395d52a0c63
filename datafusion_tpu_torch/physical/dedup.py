"""Shared-subtree deduplication: a repeated subplan executes once.

Port of ``datafusion_tpu/physical/dedup.py``.  A view or CTE referenced
twice in one query (TPC-H Q15: ``revenue0`` feeds both the join and the
scalar max subquery) plans as two structurally identical subtrees, and the
reference engine (DataFusion) pays the same double execution (views inline
per use, sql/planner.rs).  Here repeated subtrees are rewritten to the
SAME object, and ``ExecutionPlan.execute`` memoizes per (object, query
epoch): the second use reads the first use's result table.  Inside a CUDA
graph's capture the memo holds too, so the graph records the shared work
once and both uses read its tensors.

Keys are built per class from the operators' parameters (expression
reprs, join specs, limits), not from ``_display_line``, which elides
expressions for some operators.  An operator type not listed keys by its
object's identity: it is never merged.
"""

from __future__ import annotations

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
from .fuse import StageExec, TailStageExec


def _local_key(p: ExecutionPlan):
    """Class-specific parameter signature (children excluded), or None when
    the type is not recognized (never deduplicated)."""
    if isinstance(p, StageExec):
        return ("stage", p.root, _tree_key(p.inner))
    if isinstance(p, TailStageExec):
        return ("tail", p.root, _tree_key(p.inner))
    if type(p) is MemoryExec:
        # a projection changes the output columns of the SAME table object
        return ("mem", id(p.table), tuple(p.projection) if p.projection is not None else None)
    if isinstance(p, ProjectionExec):
        return ("proj", tuple((repr(e), n) for e, n in p.exprs))
    if isinstance(p, FilterExec):
        return ("filter", repr(p.predicate))
    if isinstance(p, HashAggregateExec):
        return (
            "agg",
            p.mode,
            p.distinct_values,
            tuple((repr(e), n) for e, n in p.group_expr),
            tuple(repr(a) for a in p.aggr_expr),
        )
    if isinstance(p, HashJoinExec):
        return (
            "join",
            p.join_type,
            tuple((repr(l), repr(r)) for l, r in p.on),
            repr(p.filter),
        )
    if isinstance(p, CrossJoinExec):
        return ("cross",)
    if isinstance(p, SortExec):
        return ("sort", tuple(repr(s) for s in p.sort_exprs))
    if isinstance(p, GlobalLimitExec):
        return ("limit", p.n)
    if isinstance(p, SkipExec):
        return ("skip", p.n)
    if isinstance(p, UnionExec):
        return ("union",)
    if isinstance(p, EmptyExec):
        return ("empty", tuple(p.schema().names()))
    return None


def _tree_key(p: ExecutionPlan):
    lk = _local_key(p)
    if lk is None:
        return ("id", id(p))
    return (type(p).__name__, lk) + tuple(_tree_key(c) for c in p.children())


def _expensive(p: ExecutionPlan) -> bool:
    if isinstance(p, (HashAggregateExec, HashJoinExec, SortExec, WindowAggExec)):
        return True
    return any(_expensive(c) for c in p.children())


def _merge(p: ExecutionPlan, pool: dict, before_fusion: bool) -> ExecutionPlan:
    """``p`` with each structurally repeated subtree replaced by its first
    occurrence, which is marked ``_dedup_shared``.  (A module function, not
    a closure: a recursive closure would hold the pool, and with it the
    plan, in a reference cycle.)"""
    kids = p.children()
    if before_fusion and not kids:
        return p  # leaves (scans) are shared data already
    new_kids = [_merge(c, pool, before_fusion) for c in kids]
    if any(a is not b for a, b in zip(kids, new_kids)):
        if isinstance(p, TailStageExec):
            # with_new_children returns self (the compiled stage binds its
            # source at execute()): swap in place
            p.input_exec = new_kids[0]
        else:
            p = p.with_new_children(new_kids)
    key = _tree_key(p)
    if key[0] == "id":
        return p
    prev = pool.setdefault(key, p)
    if prev is not p and (not before_fusion or _expensive(prev)):
        # the shared instance memoizes its result per query epoch
        # (ops/base.py execute)
        prev._dedup_shared = True
    return prev


class ShareCommonSubtrees:
    """Physical rule (run BEFORE fusion): merge repeated raw subtrees that
    hold expensive work into one marked instance.  FuseStages treats marked
    nodes as stage boundaries, so both referencing contexts fuse AROUND the
    shared work instead of absorbing differently shaped copies of it: Q15's
    revenue0 view would otherwise fuse as [view + 5 ops] on one side and
    [max over view + 2 ops] on the other, and nothing would be shared."""

    name = "share_common_subtrees"

    def optimize(self, plan: ExecutionPlan) -> ExecutionPlan:
        return _merge(plan, {}, True)


class DeduplicateSubtrees:
    """Physical rule (run LAST, after fusion): replace structurally equal
    subtrees with one shared instance."""

    name = "deduplicate_subtrees"

    def optimize(self, plan: ExecutionPlan) -> ExecutionPlan:
        return _merge(plan, {}, False)
