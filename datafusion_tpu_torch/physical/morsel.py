"""Morsel-streamed fused stages: run a scan-rooted stage per host morsel.

Port of ``datafusion_tpu/physical/morsel.py``.  The reference streams
batches through its operators, so no table ever has to fit in memory
(parquet.rs:596-636 blocking-reader partitions, hash_aggregate.rs partial
accumulation).  Here the unit is a MORSEL, a fixed-capacity device slice
of a host-resident table (``datasource/host.py``), and the stage runs the
same operators at the same capacity for every morsel:

  per morsel:  filters/projections (+ AGGREGATE in 'partial' mode)
  merge:       concat morsel outputs -> 'final' aggregate over states
  finish:      remaining chain ops (projections / sort / limit)

Aggregation thus uses the partial -> final machinery of two-phase
aggregation (planner.rs:526-601's split) across the morsels of one card:
states, not raw rows, accumulate on the device.  A small-domain GROUP BY
(TPC-H Q1) computes each morsel's partial states with the hand-written
kernel K1 (``ops/smalldomain.py``), once per morsel: a HostTable shares
one dictionary per column across its morsels, so every morsel has the
same domain.  Integer keys are not probed for a small range per morsel
(the stage's input arrives per execution), so they take the sort path, as
in the reference.

No per-morsel host read: a morsel's stage output is sized from a capacity
learned on the first morsel and only grown (``K.fit_learned(...,
ratchet=True)``); inside a collect's speculation window later morsels
truncate to it and record an overflow flag, and an overflow reruns the
query exactly, which learns the largest morsel's capacity.  The small
domain's partial states have a static capacity and never overflow.

So on the card a warm loop's per-morsel work is the same launches every
morsel, and it runs as one CUDA graph: captured on the loop's second
morsel and replayed for the rest (``_stream``), the host issuing one
replay per morsel where it issued a few hundred launches.
"""

from __future__ import annotations

import copy

import torch

from .. import tracing
from ..columnar.column import Column, zeros_column
from ..columnar.table import Table
from ..datasource.host import HostMemoryExec, HostTable
from ..errors import InternalError
from ..exprs.physical import PhysCol
from ..ops import kernels as K
from ..ops.aggregate import HashAggregateExec
from ..ops.base import ExecutionPlan
from ..ops.basic import GlobalLimitExec, MemoryExec, concat_tables
from ..ops.join import SHRINK_SYNC_MIN_CAP, HashJoinExec
from ..ops.sort import SortExec
from ..types.dtypes import INT64
from . import query_compiler as QC
from .stage_compiler import CompiledStage


class _SwapSource(ExecutionPlan):
    """Mutable slot: the same operator tree is reused across morsels (and
    executions) by swapping ``.table``."""

    def __init__(self, schema):
        super().__init__()
        self._schema = schema
        self.table: Table | None = None

    def schema(self):
        return self._schema

    def children(self):
        return []

    def with_new_children(self, c):
        return self

    def _execute(self) -> Table:
        if self.table is None:
            raise InternalError("_SwapSource executes only inside a morsel loop")
        return self.table


def _split_at_aggregate(chain: list, what: str):
    """(agg or None, above, below) of a fusable chain (top to bottom):
    with an aggregate, what lies above it runs once on the merged states;
    without one, every Sort and Limit runs on the concatenated morsels and
    the rest per morsel."""
    agg_idx = next((i for i, op in enumerate(chain) if isinstance(op, HashAggregateExec)), None)
    if agg_idx is not None:
        agg = chain[agg_idx]
        if agg.mode != "single":
            raise InternalError(f"{what} expects a 'single' aggregate")
        return agg, chain[:agg_idx], chain[agg_idx + 1:]
    above = [op for op in chain if isinstance(op, (SortExec, GlobalLimitExec))]
    below = [op for op in chain if not isinstance(op, (SortExec, GlobalLimitExec))]
    return None, above, below


class MorselStageExec(ExecutionPlan):
    """A fusable chain over a HostMemoryExec source, executed morsel-wise.

    ``chain`` is top-to-bottom: [Limit?, Sort?, Proj*, Agg?, Filter/Proj*]
    (the _fusable_chain grammar).  Everything below (and including) the
    aggregate runs per morsel; the final aggregate + ops above it run once
    on the merged states."""

    def __init__(self, chain: list, source: HostMemoryExec, root: bool = False):
        super().__init__()
        self.full_chain = list(chain)
        self.source = source
        self.root = root
        self.host: HostTable = source.projected_host()
        self.agg, self.above, below = _split_at_aggregate(chain, "morsel stage")
        swap = _SwapSource(self.host.schema())
        per: ExecutionPlan = swap
        for op in reversed(below):
            per = op.with_new_children([per])
        per, self._distinct_values = _attach_partial_agg(self.agg, per)
        self.per_morsel_plan = per
        self.stage = CompiledStage(per, source_node=swap)
        _init_capture_state(self)

    def schema(self):
        return self.full_chain[0].schema()

    def children(self):
        return []

    def with_new_children(self, c):
        return self

    def _display_line(self):
        r = " root" if self.root else ""
        return (
            f"MorselStageExec[fused x{len(self.full_chain)}{r}, "
            f"{self.host.num_morsels} morsels x {self.host.morsel_rows}]"
        )

    def _execute(self) -> Table:
        outs = _stream(self, lambda m: self.stage.execute(src=m, ratchet=True))
        self.metrics.counter("morsels").add(len(outs))
        with tracing.span("dftpu.morsel.merge"):
            return _merge_and_finish(
                outs, self.per_morsel_plan.schema(), self.agg, self._distinct_values,
                self.above, owner=self,
            )


# failed captures after which a morsel node stops trying (``_stream``)
MAX_CAPTURE_FAILURES = 3


def _stream(owner, body) -> list[Table]:
    """``body(morsel)`` for every morsel of ``owner.host``, in order: the
    morsels' outputs.

    On the card, in a speculation window, over at least 3 morsels, and
    once ``owner`` has run its loop before (so every capacity the body
    sizes from is learned), the morsels' work becomes one CUDA graph.  The
    first morsel runs node by node, which also fills the memos the body
    reads (a join's prepared build side, device tables); the second is
    captured over the loop's static morsel buffer (``PieceGraph``); the
    graph is replayed for it and every later morsel, the short last one
    included (its row count is a device value).  Their overflow flags
    reach the window once, summed.  A capture that fails leaves the rest
    of the loop node by node; ``owner`` counts it and stops trying after
    ``MAX_CAPTURE_FAILURES``.  Elsewhere every morsel runs node by node.
    Each morsel's span takes in the copies issued for the next one."""
    host = owner.host
    n = host.num_morsels
    morsels = host.stream_morsels()
    capture = (
        host.device.type == "cuda" and n >= 3 and K.spec_active() and owner.streamed
        and owner.capture_failures < MAX_CAPTURE_FAILURES
    )
    outs, graph = [], None
    for i in range(n):
        with tracing.span("dftpu.morsel"):
            src = None
            if capture and i > 0:
                capture = False
                graph = _capture(owner, body, morsels.next_static())
                if graph is None:
                    src = morsels.copy_static()
            elif graph is not None and graph.graph is not None:
                morsels.next_static()
            else:
                src = next(morsels)
            if src is None:
                outs.append(graph.replay())
                tracing.count("dftpu.morsel.replayed")
            else:
                outs.append(body(src))
                tracing.count("dftpu.morsel.eager")
    owner.streamed = True
    if graph is not None:
        graph.invalidate()
        if graph.flags is not None:
            K.spec_record(graph.flags)
    return outs


def _capture(owner, body, src: Table):
    """The graph of ``body(src)``, or None when the capture fails (a host
    read, an operation torch refuses inside a capture, any other error):
    the loop goes on node by node, which raises whatever is really wrong.
    ``owner`` keeps the failure (``capture_failure``) and counts it."""
    with tracing.span("dftpu.morsel.capture"):
        try:
            return QC.PieceGraph(src.device, lambda: body(src))
        except Exception as e:  # the loop must go on node by node
            owner.capture_failure = f"{type(e).__name__}: {e}{QC._where(e)}"
        owner.capture_failures += 1
        return None


def _init_capture_state(node) -> None:
    """A morsel node's state for ``_stream``: whether its loop has run
    (``streamed``), and its failed captures, the last one's message kept."""
    node.streamed = False
    node.capture_failures = 0
    node.capture_failure = None


def _attach_partial_agg(agg, per):
    """Wrap the per-morsel plan in a 'partial' aggregate.  DISTINCT stays
    correct because the partial aggregate groups by (keys + distinct
    values), so morsels emit deduplicated pairs, not states that would
    count a value once per morsel.  Returns (plan, distinct_values)."""
    if agg is None:
        return per, 0
    if any(a.distinct for a in agg.aggr_expr):
        distinct_aggs = [a for a in agg.aggr_expr if a.distinct]
        pgroup = list(agg.group_expr) + [
            (a.expr, f"__dv{i}") for i, a in enumerate(distinct_aggs)
        ]
        paggs = [a for a in agg.aggr_expr if not a.distinct]
        return HashAggregateExec("partial", pgroup, paggs, per), len(distinct_aggs)
    return HashAggregateExec("partial", agg.group_expr, agg.aggr_expr, per), 0


def _merge_and_finish(outs, pschema, agg, distinct_values, above, owner):
    """Concatenate the per-morsel outputs in morsel order, run the 'final'
    aggregate over the merged states, then the ops above the aggregate
    (Limit? Sort? Proj*).  ``owner`` (the morsel stage) keeps the finisher
    plan across executions, so the final aggregate's learned output
    capacity survives warm runs."""
    merged = outs[0] if len(outs) == 1 else concat_tables(outs, pschema)
    fin = getattr(owner, "_finisher", None)
    if fin is None:
        swap = _SwapSource(pschema)
        node: ExecutionPlan = swap
        if agg is not None:
            final_group = [
                (PhysCol(pschema.fields[i].name, i, pschema.fields[i].dtype), name)
                for i, (_, name) in enumerate(agg.group_expr)
            ]
            node = HashAggregateExec(
                "final", final_group, agg.aggr_expr, node, distinct_values=distinct_values,
            )
        for op in reversed(above):
            node = op.with_new_children([node])
        fin = owner._finisher = (swap, node)
    swap, node = fin
    swap.table = merged
    try:
        return node.execute()
    finally:
        swap.table = None


class MorselJoinStageExec(ExecutionPlan):
    """Streamed hash join over a host-resident probe side (the reference's
    pipelined streaming join: hash_join.rs probes arrive batch by batch
    against a collected build side).

    The device side executes once and stays on the device; host morsels
    stream through [host chain -> join -> mid chain -> partial agg], the
    states accumulate, and the final aggregate + above chain run on the
    merge.  Host-side row decisions are sound per morsel (each host row
    appears in exactly one morsel with the whole device side present):
    host-on-left inner/left/semi/anti, host-on-right inner/right stream
    directly.  Device-side outer rows (right/full with the host on the
    left; left/full with it on the right) stream too, through a __rowid
    column riding the device side: a visited mask accumulates across
    morsels and one final batch of the unmatched device rows, NULL-padded,
    feeds the same mid chain and partial aggregate (hash_join.rs:649's
    visited bitmap, carried across the probe stream).

    With the host on the left the device side is the join's build side:
    its hash, sort and verify keys are prepared once per execution
    (``ops/join.py``, ``reused_build``), so per-morsel work scales with
    the morsel.  The host chain and the [mid chain, partial agg] run as
    fused stages with capacities learned across morsels, so a warm morsel
    reads nothing on the host."""

    HOST_LEFT_TYPES = ("inner", "left", "semi", "anti", "right", "full")
    HOST_RIGHT_TYPES = ("inner", "right", "left", "full")

    def __init__(self, chain, join, host_chain, host_source, host_on_left, build, root=False):
        super().__init__()
        self.full_chain = list(chain)
        self.join = join
        self.host_chain = list(host_chain)
        self.source = host_source
        self.host_on_left = host_on_left
        self.build = build
        self.root = root
        self.host: HostTable = host_source.projected_host()
        self.agg, self.above, self.mid = _split_at_aggregate(chain, "morsel join stage")
        jt = join.join_type
        self.device_outer = jt in ("right", "full") if host_on_left else jt in ("left", "full")

        # the host chain, fused over each morsel
        swap = _SwapSource(self.host.schema())
        probe: ExecutionPlan = swap
        for op in reversed(self.host_chain):
            probe = op.with_new_children([probe])
        self._host_stage = CompiledStage(probe, source_node=swap) if self.host_chain else None
        # the join's host-side input slot: each morsel, after the host chain
        self._probe = _SwapSource(probe.schema())
        # mid chain + partial aggregate over the join's output schema, fused;
        # per-morsel join outputs and the final unmatched batch both feed it
        swap2 = _SwapSource(join.schema())
        node: ExecutionPlan = swap2
        for op in reversed(self.mid):
            node = op.with_new_children([node])
        per, self._distinct_values = _attach_partial_agg(self.agg, node)
        self._per_schema = per.schema()
        self._per_stage = CompiledStage(per, source_node=swap2) if per is not swap2 else None
        _init_capture_state(self)

    def schema(self):
        return (self.full_chain[0] if self.full_chain else self.join).schema()

    def children(self):
        return [self.build]

    def with_new_children(self, c):
        return MorselJoinStageExec(
            self.full_chain, self.join, self.host_chain, self.source,
            self.host_on_left, c[0], self.root,
        )

    def _display_line(self):
        r = " root" if self.root else ""
        side = "left" if self.host_on_left else "right"
        return (
            f"MorselJoinStageExec[{self.join.join_type}, host-{side}, "
            f"fused x{len(self.full_chain) + 1 + len(self.host_chain)}{r}, "
            f"{self.host.num_morsels} morsels x {self.host.morsel_rows}]"
        )

    def _per_join(self, build_tbl: Table):
        """(join over [probe slot, device side], device-side table,
        __rowid column index or None) for one execution."""
        jt = self.join.join_type
        # sized once, and one object for every morsel: the join keeps the
        # prepared build side on it
        dev_tbl = build_tbl.shrink_to_fit(only_if_above=SHRINK_SYNC_MIN_CAP)
        nb = len(dev_tbl.columns)
        if not self.device_outer:
            side = Table(dev_tbl.names, dev_tbl.columns, dev_tbl.nrows_dev, device=dev_tbl.device)
            bmem = MemoryExec(side, self.build.schema())
            per_join, rowid_idx = self.join, None
        else:
            # a __rowid column on the device side; the per-morsel join keeps
            # only the host side's outer rows, the device side's unmatched
            # rows come once at the end from the visited mask
            rcap = dev_tbl.capacity
            rowid = Column(INT64, torch.arange(rcap, device=dev_tbl.device),
                           torch.ones(rcap, dtype=torch.bool, device=dev_tbl.device))
            side = Table(list(dev_tbl.names) + ["__rowid"], list(dev_tbl.columns) + [rowid],
                         dev_tbl.nrows_dev, device=dev_tbl.device)
            bmem = MemoryExec(side, side.schema())
            per_jt = ({"right": "inner", "full": "left"} if self.host_on_left
                      else {"left": "inner", "full": "right"})[jt]
            per_filter = self.join.filter
            if per_filter is not None and not self.host_on_left:
                # __rowid sits between the device and host columns; shift
                # the residual filter's host-side column indices past it
                per_filter = copy.deepcopy(per_filter)
                _shift_cols(per_filter, nb)
            per_join = HashJoinExec(self.join.left, self.join.right, self.join.on, per_jt, per_filter)
            # __rowid is the device side's last column: last overall with
            # the host on the left, at index nb (before the host's) on the right
            rowid_idx = len(self.join.schema().fields) if self.host_on_left else nb
        if self.host_on_left:
            side.reused_build = True
        kids = [self._probe, bmem] if self.host_on_left else [bmem, self._probe]
        return per_join.with_new_children(kids), dev_tbl, rowid_idx

    def _execute(self) -> Table:
        jschema = self.join.schema()
        join_node, dev_tbl, rowid_idx = self._per_join(self.build.execute())
        probe = self._probe
        rcap = dev_tbl.capacity
        # the device rows some morsel matched, updated in place (a graph
        # replays the update)
        visited = None
        if rowid_idx is not None:
            visited = torch.zeros(rcap, dtype=torch.bool, device=dev_tbl.device)
        out_dics: list = []

        def body(cur: Table) -> Table:
            if self._host_stage is not None:
                cur = self._host_stage.execute(src=cur, ratchet=True)
            probe.table = cur
            jt_out = join_node.execute()
            if rowid_idx is not None:
                rid = jt_out.columns[rowid_idx]
                live = torch.arange(jt_out.capacity, device=rid.data.device) < jt_out.nrows_dev
                # the device rows this morsel matched (slot rcap: no match)
                idx = torch.where(rid.valid & live, rid.data, rcap)
                upd = torch.zeros(rcap + 1, dtype=torch.bool, device=idx.device).index_fill_(0, idx, True)
                visited.logical_or_(upd[:rcap])
                keep = [j for j in range(len(jt_out.columns)) if j != rowid_idx]
                if not out_dics:
                    out_dics.extend(jt_out.columns[j].dictionary for j in keep)
                jt_out = Table([jt_out.names[j] for j in keep], [jt_out.columns[j] for j in keep],
                               jt_out.nrows_dev, device=jt_out.device)
            return self._per_morsel(jt_out)

        try:
            outs = _stream(self, body)
        finally:
            probe.table = None
        self.metrics.counter("morsels").add(len(outs))
        with tracing.span("dftpu.morsel.merge"):
            if rowid_idx is not None:
                outs.append(self._per_morsel(self._unmatched(jschema, dev_tbl, visited, out_dics)))
            return _merge_and_finish(
                outs, self._per_schema, self.agg, self._distinct_values, self.above, owner=self,
            )

    def _per_morsel(self, jt_out: Table) -> Table:
        if self._per_stage is None:
            return jt_out
        return self._per_stage.execute(src=jt_out, ratchet=True)

    def _unmatched(self, jschema, dev_tbl: Table, visited, out_dics) -> Table:
        """The device side's rows no morsel matched, NULL-padded on the
        host side, in the join's output layout."""
        rcap = dev_tbl.capacity
        dev = dev_tbl.device
        r_alive = torch.arange(rcap, device=dev) < dev_tbl.nrows_dev
        keep = r_alive & ~visited
        nb = len(dev_tbl.columns)
        nh = len(jschema.fields) - nb
        hfields = jschema.fields[:nh] if self.host_on_left else jschema.fields[nb:]
        null_d = tuple(zeros_column(f.dtype, rcap, dev).data for f in hfields)
        null_v = tuple(torch.zeros(rcap, dtype=torch.bool, device=dev) for _ in hfields)
        bd = tuple(c.data for c in dev_tbl.columns)
        bv = tuple(c.valid & keep for c in dev_tbl.columns)
        datas = null_d + bd if self.host_on_left else bd + null_d
        valids = null_v + bv if self.host_on_left else bv + null_v
        out_d, out_v, cnt = K.filter_compact(datas, valids, keep, dev_tbl.nrows_dev)
        cols = [
            Column(f.dtype, d, v, dic)
            for f, dic, d, v in zip(jschema.fields, out_dics, out_d, out_v)
        ]
        return Table([f.name for f in jschema.fields], cols, cnt, device=dev)


def _shift_cols(e, nb: int) -> None:
    """Shift every column index at or past ``nb`` in ``e`` by one."""
    if isinstance(e, PhysCol) and e.index >= nb:
        e.index += 1
    for c in e.children():
        _shift_cols(c, nb)
