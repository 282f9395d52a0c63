"""ExecutionPlan: the physical operator contract.

Port of ``datafusion_tpu/ops/base.py``: the reference's ExecutionPlan
trait (datafusion/src/physical_plan/mod.rs:152-197) with one difference:
instead of per-partition async RecordBatch streams, execute() transforms
ONE device-resident Table per call.

Per-operator metrics mirror SQLMetric (mod.rs:59-122).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch

from ..columnar.table import BUILD, HOST_SYNCS, Table
from ..device import capturing
from ..types import Schema


@dataclass
class SQLMetric:
    """Counter or nanosecond timer (reference physical_plan/mod.rs:59-122)."""

    name: str
    value: int = 0
    is_time: bool = False

    def add(self, n: int):
        self.value += n


class MetricsSet:
    def __init__(self):
        self._metrics: dict[str, SQLMetric] = {}

    def counter(self, name: str) -> SQLMetric:
        if name not in self._metrics:
            self._metrics[name] = SQLMetric(name)
        return self._metrics[name]

    def timer(self, name: str) -> SQLMetric:
        if name not in self._metrics:
            self._metrics[name] = SQLMetric(name, is_time=True)
        return self._metrics[name]

    def items(self):
        return self._metrics.items()


# per-thread execution scope: top-level execute() calls open a new epoch
# (shared-subtree memos are valid only within one epoch)
_EXEC_STATE = threading.local()


class ExecutionPlan:
    """Base physical operator."""

    def __init__(self):
        self.metrics = MetricsSet()

    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> list["ExecutionPlan"]:
        return []

    def with_new_children(self, children: list["ExecutionPlan"]) -> "ExecutionPlan":
        raise NotImplementedError

    def execute(self) -> Table:
        """Run this operator (and its inputs) to completion on this device.

        A node marked by DeduplicateSubtrees (physical/dedup.py) as shared
        memoizes its result for the duration of one top-level execution: a
        view/CTE referenced twice runs once.  The epoch bumps whenever a
        new top-level execute() begins (depth 0), so repeated runs of the
        same plan object — warm benchmarks, speculative-overflow exact
        reruns — never see a stale memo."""
        st = _EXEC_STATE
        depth = getattr(st, "depth", 0)
        if depth == 0:
            st.epoch = getattr(st, "epoch", 0) + 1
        if getattr(self, "_dedup_shared", False):
            memo = getattr(self, "_dedup_memo", None)
            if memo is not None and memo[0] == getattr(st, "epoch", 0):
                return memo[1]
        st.depth = depth + 1
        try:
            t0 = time.perf_counter_ns()
            self.metrics.counter("executions").add(1)
            out = self._execute()
            # host time: kernels are queued asynchronously, so this times
            # the enqueue, not the device work
            self.metrics.timer("elapsed_ns").add(time.perf_counter_ns() - t0)
        except Exception as e:
            # a failed whole-query build names its innermost operator
            if BUILD.active and getattr(e, "node", None) is None:
                e.node = self._display_line()
            raise
        finally:
            st.depth = depth
        # record the count, not out.nrows: reading nrows here would force a
        # device sync per operator (Table keeps lazy device-resident counts);
        # collect_plan_metrics reads it on harvest.  Only the count: a cached
        # plan that kept each operator's last output would hold every
        # intermediate table on the card between collects.  Not while a CUDA
        # graph is captured: its tensors hold nothing until a replay
        if not capturing():
            self._metrics_out = out.nrows_dev
        if getattr(self, "_dedup_shared", False):
            self._dedup_memo = (st.epoch, out)
        return out

    def _execute(self) -> Table:
        raise NotImplementedError

    def lazy_metric(self, name: str, value) -> None:
        """Add ``value`` to the counter ``name``.  A device count is summed
        on the device and read when the metrics are harvested
        (``collect_plan_metrics``), so recording it waits for nothing; a
        graph's capture records nothing (its tensors hold no values)."""
        if isinstance(value, int):
            self.metrics.counter(name).add(value)
        elif not capturing():
            lazy = self.__dict__.setdefault("_lazy_metrics", {})
            lazy[name] = lazy.get(name, 0) + value.to(torch.int64)

    # ---- hints for the planner/optimizer (OptimizerHints, mod.rs:129-139) --
    def output_sort_order(self) -> list | None:
        """[(column_index, ascending, nulls_first), ...] when this operator
        guarantees its output row order, else None.  Consumed by
        SortedAggregateRule / EliminateRedundantSort (the fork's
        compute_aggregation_strategy + OptimizerHints machinery)."""
        return None

    # ---- display -------------------------------------------------------------
    def display(self, indent: int = 0) -> str:
        pad = "  " * indent
        s = pad + self._display_line()
        for c in self.children():
            s += "\n" + c.display(indent + 1)
        return s

    def _display_line(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.display()


def collect_plan_metrics(plan: ExecutionPlan, out=None) -> dict:
    """Harvest metrics from a plan tree (plan_metrics, mod.rs:322)."""
    out = out if out is not None else {}
    key = type(plan).__name__
    mo = getattr(plan, "_metrics_out", None)
    if mo is not None:
        if not isinstance(mo, int):
            HOST_SYNCS[0] += 1
            mo = int(mo)
        plan.metrics.counter("output_rows").add(mo)
        plan._metrics_out = None
    for name, v in plan.__dict__.pop("_lazy_metrics", {}).items():
        plan.metrics.counter(name).add(int(v))
    for name, m in plan.metrics.items():
        out.setdefault(f"{key}.{name}", 0)
        out[f"{key}.{name}"] += m.value
    for c in plan.children():
        collect_plan_metrics(c, out)
    return out
