"""WindowAggExec: window functions as segment scans over one sort.

Port of ``datafusion_tpu/ops/window.py`` (reference:
datafusion/src/physical_plan/windows/, window_agg_exec.rs:42,
aggregate.rs:36 AggregateWindowExpr, built_in.rs:35).  One lexsort by
(partition keys, order keys), partition ids from the key boundaries, then
every function is a vectorized pass over the sorted rows:
  row_number    -> position - partition start
  rank          -> each row's peer-group start (binary search over the
                   prefix sum of the peer boundaries)
  dense_rank    -> cumsum of the peer boundaries within the partition
  percent_rank / cume_dist -> rank arithmetic over partition sizes
  ntile(n)      -> bucket arithmetic
  lag/lead      -> shifted gather with a partition guard
  first/last/nth_value -> partition-start/end gathers
  aggregates    -> per-row frame bounds [lo, hi] (ROWS offsets, RANGE and
                   GROUPS with or without offsets), prefix sums for
                   sum/count/avg and a sparse table for min/max
Output rows stay in (partition, order) sorted order, as in the reference.
Nothing is read on the host, so a warm window plan is captured whole.
The tracer's span ``dftpu.window`` holds one window's work, split into
``.sort``, ``.partition`` and ``.eval``; a graph's replay records none.
The reference's per-shape ``jax.jit`` cache has no counterpart.

The float sums and the binary searches follow the reference's order of
operations (``kernels._segment_scan`` adds as its associative scan does;
the frame bisections run the same fixed number of halving steps), so both
engines give the same bits.  The sparse table of min/max keeps one level
at a time and reads each row at its own level, so its memory is two
columns instead of the reference's log2(capacity) + 1.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from .. import tracing
from ..columnar.column import Column
from ..columnar.table import Table
from ..device import torch_dtype
from ..errors import PlanError
from ..exprs.physical import PhysicalExpr
from ..functions.aggregates import is_aggregate_function
from ..types import Field, Schema
from ..types.dtypes import DataType, FLOAT64, INT64, UINT64
from . import kernels as K
from .base import ExecutionPlan
from .sort import PhysSortExpr, sort_table


class PhysWindowExpr:
    def __init__(
        self,
        fun: str,
        args: list[PhysicalExpr],
        partition_by: list[PhysicalExpr],
        order_by: list[PhysSortExpr],
        name: str,
        dtype: DataType,
        frame=None,
    ):
        self.fun = fun.lower()
        self.args = args
        self.partition_by = partition_by
        self.order_by = order_by
        self.name = name
        self.dtype = dtype
        self.frame = frame

    def __repr__(self):
        return f"{self.fun}(...) as {self.name}"


class WindowAggExec(ExecutionPlan):
    def __init__(self, window_exprs: list[PhysWindowExpr], input: ExecutionPlan):
        super().__init__()
        self.window_exprs = window_exprs
        self.input = input

    def schema(self) -> Schema:
        fields = list(self.input.schema().fields)
        for w in self.window_exprs:
            fields.append(Field(w.name, w.dtype, True))
        return Schema(fields)

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return WindowAggExec(self.window_exprs, c[0])

    def _execute(self) -> Table:
        t = self.input.execute()
        names, cols = self._traced_window(t, t.nrows_dev, t.capacity)
        return Table(names, cols, t.nrows_dev, device=t.device)

    @tracing.spanned("dftpu.window")
    def _traced_window(self, t: Table, nrows, cap):
        """(names, columns) of the input's columns sorted by the window's
        partition and order keys, then one column per window expression.
        The stage compiler calls it on a view of a fused stage's buffers."""
        # the planner gives every expression of one exec the same partition
        # and order keys: sort once by the first's
        w0 = self.window_exprs[0]
        specs = [PhysSortExpr(p, True, True) for p in w0.partition_by] + list(w0.order_by)
        tracing.count("dftpu.window.exprs", len(self.window_exprs))
        if specs:
            tracing.count("dftpu.window.rows", cap)
            with tracing.span("dftpu.window.sort"):
                t = sort_table(Table(t.names, t.columns, nrows, device=t.device), specs)
        with tracing.span("dftpu.window.partition"):
            dev = t.device
            ar = torch.arange(cap, device=dev)
            alive = ar < nrows
            if w0.partition_by:
                pcols = [p.evaluate(t) for p in w0.partition_by]
                gid, _ = K.group_ids_sorted(
                    tuple(K.orderable_key(c.data, c.dtype) for c in pcols),
                    tuple(c.valid for c in pcols),
                    nrows,
                )
            else:
                gid = torch.where(alive, 0, cap - 1)
            seg = K.segments(gid)
            p = _Partitions(gid, seg.start, seg.last[gid] - seg.start + 1, alive, ar)
        names, cols = list(t.names), list(t.columns)
        with tracing.span("dftpu.window.eval"):
            for w in self.window_exprs:
                names.append(w.name)
                cols.append(self._eval_window(w, t, p))
        return names, cols

    # ------------------------------------------------------------------
    def _eval_window(self, w: PhysWindowExpr, t: Table, p: "_Partitions") -> Column:
        f = w.fun
        alive, ar, cap = p.alive, p.ar, p.ar.shape[0]
        pos = ar - p.start

        if f == "row_number":
            return Column(UINT64, (pos + 1).view(torch.uint64), alive)

        if f in ("rank", "dense_rank", "percent_rank", "cume_dist"):
            boundary = _peer_boundary(w, t, p.gid)
            peer_start, peer_end = _peers(boundary)
            rank = peer_start - p.start + 1
            if f == "rank":
                return Column(UINT64, rank.view(torch.uint64), alive)
            if f == "dense_rank":
                dr = _segment_cumsum(boundary.to(torch.int64), p.start)
                return Column(UINT64, dr.view(torch.uint64), alive)
            if f == "percent_rank":
                denom = torch.clamp(p.size - 1, min=1).to(torch.float64)
                return Column(FLOAT64, (rank - 1).to(torch.float64) / denom, alive)
            cd = (peer_end - p.start + 1).to(torch.float64) / torch.clamp(p.size, min=1).to(torch.float64)
            return Column(FLOAT64, cd, alive)

        if f == "ntile":
            nt = w.args[0].evaluate(t).data.to(torch.int64)
            bucket = (pos * nt) // torch.clamp(p.size, min=1) + 1
            return Column(UINT64, bucket.view(torch.uint64), alive)

        if f in ("lag", "lead"):
            v = w.args[0].evaluate(t)
            # the offset stays on the device: a literal argument is a
            # column of the (sorted) table, read at row 0 without a sync
            if len(w.args) > 1:
                offset = w.args[1].evaluate(t).data[0].to(torch.int64)
            else:
                offset = 1
            src = ar - offset if f == "lag" else ar + offset
            src_c = torch.clamp(src, 0, cap - 1)
            ok = alive & (src >= 0) & (src < cap) & (p.gid[src_c] == p.gid)
            return K.take_columns((v,), src_c, ok)[0]

        if f in ("first_value", "last_value", "nth_value"):
            v = w.args[0].evaluate(t)
            if f == "first_value":
                src = p.start
            elif f == "last_value":
                src = p.start + p.size - 1
            else:
                n = w.args[1].evaluate(t).data[0].to(torch.int64)
                src = p.start + (n - 1)
            src_c = torch.clamp(src, 0, cap - 1)
            ok = alive & (src >= p.start) & (src < p.start + p.size)
            return K.take_columns((v,), src_c, ok)[0]

        if is_aggregate_function(f):
            v = w.args[0].evaluate(t) if w.args else None
            lo, hi, span = _frame_bounds(w, t, p)
            return _window_aggregate_range(f, v, w.dtype, p, lo, hi, span)

        raise PlanError(f"window function '{f}' not implemented")

    def _display_line(self):
        return f"WindowAggExec: {self.window_exprs}"


class _Partitions:
    """The sorted rows' partitions: ``gid`` (dense partition id, dead rows
    at cap - 1), ``start`` and ``size`` of each row's partition, the live
    mask and the row positions."""

    def __init__(self, gid, start, size, alive, ar):
        self.gid, self.start, self.size, self.alive, self.ar = gid, start, size, alive, ar

    @property
    def end(self):
        return self.start + self.size - 1


# ---------------------------------------------------------------------------
# peers and frames
# ---------------------------------------------------------------------------


def _peer_boundary(w, t, gid) -> torch.Tensor:
    """True at each row that starts an ORDER BY peer group (a change of
    any order key's data or validity, or of the partition)."""
    cap = gid.shape[0]
    boundary = torch.zeros(cap, dtype=torch.bool, device=gid.device)
    for s in w.order_by:
        c = s.expr.evaluate(t)
        boundary = K._boundary_accum(boundary, K.orderable_key(c.data, c.dtype), c.valid)
    boundary = boundary | (gid != torch.roll(gid, 1))
    boundary[:1].fill_(True)
    return boundary


def _peers(boundary):
    """(first, last) row of each row's peer group.  The reference takes a
    running maximum of the boundary positions and a running minimum from
    the end; torch's cummax and cummin take about 6 ms each over 2 M rows
    on an NVIDIA H100 80GB HBM3 at 700 W, so here the groups are numbered
    by a prefix sum of the boundaries and found by binary search
    (``kernels.segments``)."""
    peer = torch.cumsum(boundary, 0) - 1
    seg = K.segments(peer)
    return seg.start, seg.last[peer]


def _peer_bounds(w, t, p):
    """(first, last) row of each row's ORDER BY peer group (RANGE frame
    semantics); the whole partition without ORDER BY."""
    if not w.order_by:
        return p.start, p.end
    return _peers(_peer_boundary(w, t, p.gid))


def _frame_bounds(w, t, p):
    """Per-row inclusive [lo, hi] frame over the sorted rows
    (window_frames.rs semantics), and the most rows a frame can span when
    that is known from the frame alone (ROWS with two offsets), else
    None."""
    frame = w.frame
    if frame is None:
        if w.order_by:
            # the SQL default, RANGE UNBOUNDED PRECEDING .. CURRENT ROW:
            # every peer of the current row is in the frame
            return p.start, _peer_bounds(w, t, p)[1], None
        return p.start, p.end, None

    has_offset = frame.start.offset is not None or frame.end.offset is not None
    if frame.units == "range" and has_offset:
        return (*_range_offset_bounds(w, t, p, frame), None)
    if frame.units == "groups" and has_offset:
        return (*_groups_offset_bounds(w, t, p, frame), None)
    if frame.units in ("range", "groups"):
        ps, pe = _peer_bounds(w, t, p)
        if frame.start.kind == "preceding":  # UNBOUNDED PRECEDING
            lo = p.start
        elif frame.start.kind == "current":
            lo = ps
        else:
            raise PlanError("frame start UNBOUNDED FOLLOWING is invalid")
        if frame.end.kind == "current":
            hi = pe
        elif frame.end.kind == "following":  # UNBOUNDED FOLLOWING
            hi = p.end
        else:
            raise PlanError("frame end UNBOUNDED PRECEDING is invalid")
        return lo, hi, None
    return _rows_bounds(frame, p)


def _rows_bounds(frame, p):
    ar, cap = p.ar, p.ar.shape[0]

    def bound(b, is_start):
        """(the bound's rows, its offset from the current row, or None
        when it is unbounded)."""
        if b.offset is not None:
            off = int(b.offset) if b.kind == "following" else -int(b.offset)
            return ar + off, off
        if b.kind == "current":
            return ar, 0
        if b.kind == "preceding":
            return (p.start if is_start else torch.full_like(ar, -1)), None
        return (torch.full_like(ar, cap) if is_start else p.end), None

    (lo, lo_off), (hi, hi_off) = bound(frame.start, True), bound(frame.end, False)
    span = None if lo_off is None or hi_off is None else max(hi_off - lo_off + 1, 1)
    return torch.maximum(lo, p.start), torch.minimum(hi, p.end), span


def _bisector(key, p):
    """``bisect_left(target)``: per row, the first position in
    [partition start, partition end + 1) whose key is not below the row's
    target, by the reference's fixed number of halving steps over gathers
    (the rows of a partition are in key order)."""
    cap = p.ar.shape[0]
    steps = (max(cap, 2) - 1).bit_length() + 1  # ceil(log2(cap)) + 1

    def bisect_left(target):
        lo, hi = p.start, torch.clamp(p.end + 1, max=cap)
        for _ in range(steps):
            mid = (lo + hi) // 2
            go = key[torch.clamp(mid, 0, cap - 1)] < target
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(go, hi, mid)
        return lo

    return bisect_left


def _groups_offset_bounds(w, t, p, frame):
    """GROUPS BETWEEN x PRECEDING AND y FOLLOWING: the frame spans whole
    peer groups; the dense peer index within the partition is the bisected
    key."""
    boundary = _peer_boundary(w, t, p.gid)
    peer_global = torch.cumsum(boundary.to(torch.int64), 0)
    cap = p.ar.shape[0]
    cur = peer_global - peer_global[torch.clamp(p.start, 0, cap - 1)]
    bisect_left = _bisector(cur, p)
    s, e = frame.start, frame.end
    if s.kind == "preceding":
        lo = p.start if s.offset is None else bisect_left(cur - int(s.offset))
    elif s.kind == "current":
        lo = bisect_left(cur)
    else:
        lo = bisect_left(cur + int(s.offset))
    if e.kind == "following":
        hi = p.end if e.offset is None else bisect_left(cur + int(e.offset) + 1) - 1
    elif e.kind == "current":
        hi = bisect_left(cur + 1) - 1
    else:
        hi = bisect_left(cur - int(e.offset) + 1) - 1
    return torch.maximum(lo, p.start), torch.minimum(hi, p.end)


def _range_offset_bounds(w, t, p, frame):
    """RANGE BETWEEN x PRECEDING AND y FOLLOWING over ONE numeric ORDER BY
    key: per row, a bisection for the first and last row whose key lies in
    [cur - x, cur + y]."""
    if len(w.order_by) != 1:
        raise PlanError("RANGE with offsets requires exactly one ORDER BY key")
    s = w.order_by[0]
    c = s.expr.evaluate(t)
    key = K.orderable_key(c.data, c.dtype)
    if s.ascending is False:
        key = -key  # frames are defined on the sort direction's axis
    cur = key

    def off(x):
        # offsets live on the SQL value axis: over DECIMAL(_, 2) a RANGE of
        # 1 spans 100 storage units
        if c.dtype.is_decimal:
            v = Fraction(str(x)) * (10 ** c.dtype.scale)
            if v.denominator != 1:
                raise PlanError("RANGE offset finer than the ORDER BY decimal scale")
            return int(v)
        if c.dtype.is_float:
            return float(x)
        fx = float(x)
        if fx != int(fx):
            raise PlanError("RANGE offset must be an integer for integer ORDER BY keys")
        return int(fx)

    bisect_left = _bisector(key, p)

    def first_above(delta):
        # the first row whose key is strictly above cur + delta: integer
        # keys step by one storage unit, floats to the next double up
        target = cur + delta
        if c.dtype.is_float:
            return bisect_left(torch.nextafter(target, torch.full_like(target, float("inf"))))
        return bisect_left(target + 1)

    st, en = frame.start, frame.end
    if st.kind == "preceding":
        lo = p.start if st.offset is None else bisect_left(cur - off(st.offset))
    elif st.kind == "current":
        lo = bisect_left(cur)
    else:
        lo = bisect_left(cur + off(st.offset))
    if en.kind == "following":
        hi = p.end if en.offset is None else first_above(off(en.offset)) - 1
    elif en.kind == "current":
        hi = first_above(0) - 1
    else:
        hi = first_above(-off(en.offset)) - 1
    lo = torch.maximum(lo, p.start)
    hi = torch.minimum(hi, p.end)
    # NULL order keys sort into one run; their frame is that peer group
    ps, pe = _peer_bounds(w, t, p)
    return torch.where(c.valid, lo, ps), torch.where(c.valid, hi, pe)


# ---------------------------------------------------------------------------
# frame aggregates
# ---------------------------------------------------------------------------


def _segment_cumsum(x, start):
    """Inclusive cumulative sum within partitions (rows sorted by them)."""
    total = torch.cumsum(x, 0)
    return total - (total[start] - x[start])


def _range_sum(x, p, lo, hi):
    """Per-row sum over the inclusive rows [lo, hi] of its partition: a
    within-partition prefix and two gathers.  Integer prefixes are one
    cumsum (exact mod 2^64 in any order); float prefixes add in the
    reference's associative-scan order."""
    cap = x.shape[0]
    if x.is_floating_point():
        run = K._segment_scan(x, p.gid, torch.add)
    else:
        run = _segment_cumsum(x, p.start)
    lo_c = torch.clamp(lo, 0, cap - 1)
    hi_c = torch.clamp(hi, 0, cap - 1)
    prev = torch.clamp(lo_c - 1, 0, cap - 1)
    prev_same = (lo_c > 0) & (p.gid[prev] == p.gid[lo_c])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = run[hi_c] - torch.where(prev_same, run[prev], zero)
    return torch.where(hi >= lo, s, zero)


def _range_minmax(x, lo, hi, opfn, neutral, span):
    """Per-row min/max over [lo, hi] from a sparse table: level k holds the
    reduction of the 2^k rows from each position; a row reads the two
    blocks of its level (the largest 2^k not above its frame's length)
    that cover its frame.  The levels are built one after another and each
    row is answered at its own level, so only two levels are ever held.
    ``span`` bounds the frame length when the frame alone fixes it."""
    cap = x.shape[0]
    levels = max(1, (max(cap, 2) - 1).bit_length() + 1)
    if span is not None:
        levels = min(levels, span.bit_length())
    ln = torch.clamp(hi - lo + 1, min=1)
    # floor(log2(len)) from the integer bits, with no float in the way
    k = torch.zeros_like(ln)
    for j in range(1, levels):
        k += (ln >> j) > 0
    lo_c = torch.clamp(lo, 0, cap - 1)
    out = torch.full_like(x, neutral)
    cur = x
    for lvl in range(levels):
        if lvl:
            d = 1 << (lvl - 1)
            cur = opfn(cur, torch.cat([cur[d:], torch.full((d,), neutral, dtype=cur.dtype, device=cur.device)]))
        right = torch.clamp(hi - (1 << lvl) + 1, 0, cap - 1)
        out = torch.where(k == lvl, opfn(cur[lo_c], cur[right]), out)
    return torch.where(hi >= lo, out, torch.full_like(out, neutral))


def _window_aggregate_range(f, v, dtype, p, lo, hi, span):
    """A frame-aware window aggregate over per-row row ranges [lo, hi]
    (AggregateWindowExpr, windows/aggregate.rs:36, with real frames)."""
    from .aggregate import to_float

    alive = p.alive
    if f == "count":
        x = (alive if v is None else (v.valid & alive)).to(torch.int64)
        return Column(INT64, _range_sum(x, p, lo, hi), alive)

    mask = v.valid & alive
    cnt = _range_sum(mask.to(torch.int64), p, lo, hi)
    has = (hi >= lo) & (cnt > 0)

    if f == "sum":
        sdt = torch_dtype(dtype.storage_np_dtype())
        acc = K.signed_view(v.data.to(sdt))
        x = torch.where(mask, acc, torch.zeros((), dtype=acc.dtype, device=acc.device))
        return Column(dtype, _range_sum(x, p, lo, hi).view(sdt), alive & has)
    if f in ("avg", "mean"):
        x = torch.where(mask, to_float(v.data, v.dtype), 0.0)
        s = _range_sum(x, p, lo, hi)
        return Column(FLOAT64, s / torch.clamp(cnt, min=1), alive & has)
    if f in ("min", "max"):
        opfn = K.xla_minimum if f == "min" else K.xla_maximum
        if v.dtype.is_float:
            neutral = float("inf") if f == "min" else float("-inf")
            x = torch.where(mask, v.data, torch.full((), neutral, dtype=v.data.dtype, device=v.data.device))
        else:
            x = K.orderable_key(v.data, v.dtype)
            info = torch.iinfo(x.dtype)
            neutral = info.max if f == "min" else info.min
            x = torch.where(mask, x, torch.full((), neutral, dtype=x.dtype, device=x.device))
        out = _range_minmax(x, lo, hi, opfn, neutral, span)
        out = out.to(torch_dtype(v.dtype.storage_np_dtype()))
        return Column(v.dtype, out, alive & has, v.dictionary)
    raise PlanError(f"window aggregate '{f}' not implemented")
