"""RollingWindowAggExec: rolling aggregates over a dense grid.

Port of ``datafusion_tpu/ops/rolling.py`` (reference:
datafusion/src/cube_ext/rolling.rs:359, RollingWindowAggExec, the
CubeStore ROLLING_WINDOW extension).  The reference walks per-partition
cursors over sorted batches; here the grid is materialized:

  1. bucket = (dimension - FROM) // EVERY per row;
  2. the rows are grouped by partition keys (the sort path's grouping) and
     sorted by grid cell, partition * nbuckets + bucket; one binary search
     per cell finds its rows, and each aggregate's per-cell values fill a
     dense [nparts, nbuckets] matrix (nbuckets comes from the FROM/TO/EVERY
     literals);
  3. a rolling window reduces along the bucket axis: prefix sums for
     sum/count/avg, cumulative min/max;
  4. the output is nparts x nbuckets rows: partition keys, the grid value,
     the rolling values and, with GROUP BY DIMENSION, each bucket's own
     aggregates.

Offsets (RANGE k PRECEDING/FOLLOWING) must be multiples of EVERY.  The
reference reads the partition count on the host; here the first run
(exact) reads it and learns it, and inside a speculation window later runs
size the grid from the learned count with an overflow flag, so a warm plan
reads nothing on the host.  Per-cell float sums add in a fixed order (a
segmented scan over the cell-sorted rows), so a card's result does not
change from run to run.  The tracer's span ``dftpu.rolling`` holds the
operator's work after its input has run.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..columnar.column import Column
from ..columnar.table import Table, round_capacity
from ..device import torch_dtype
from ..errors import PlanError
from ..types import Field, Schema
from . import kernels as K
from .aggregate import PhysAggExpr, group_rows, to_float
from .base import ExecutionPlan


class PhysRollingAgg:
    def __init__(self, agg: PhysAggExpr, preceding: int | None, following: int):
        """preceding: buckets before the grid point (None = unbounded);
        following: buckets after (0 = current)."""
        self.agg = agg
        self.preceding = preceding
        self.following = following


class RollingWindowAggExec(ExecutionPlan):
    def __init__(
        self,
        input: ExecutionPlan,
        dimension,  # PhysicalExpr (a column)
        dim_field: Field,
        from_v: int,
        to_v: int,
        every_v: int,
        partition_by: list,  # [(PhysicalExpr, name)]
        rolling_aggs: list[PhysRollingAgg],
        group_by_dimension=None,  # PhysicalExpr | None
        aggs: list[PhysAggExpr] | None = None,
    ):
        super().__init__()
        if every_v <= 0:
            raise PlanError("EVERY must be positive")
        if to_v < from_v:
            raise PlanError("TO is less than FROM")
        self.input = input
        self.dimension = dimension
        self.dim_field = dim_field
        self.from_v = int(from_v)
        self.to_v = int(to_v)
        self.every_v = int(every_v)
        self.partition_by = partition_by
        self.rolling_aggs = rolling_aggs
        self.group_by_dimension = group_by_dimension
        self.aggs = aggs or []
        self.nbuckets = (self.to_v - self.from_v) // self.every_v + 1
        self._learned: dict = {}  # the partition count, per input capacity

    def schema(self) -> Schema:
        fields = [Field(n, e.dtype, True) for e, n in self.partition_by]
        fields.append(self.dim_field)
        for r in self.rolling_aggs:
            fields.append(Field(r.agg.name, r.agg.return_type(), True))
        for a in self.aggs:
            fields.append(Field(a.name, a.return_type(), True))
        return Schema(fields)

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return RollingWindowAggExec(
            c[0], self.dimension, self.dim_field, self.from_v, self.to_v,
            self.every_v, self.partition_by, self.rolling_aggs,
            self.group_by_dimension, self.aggs,
        )

    # ------------------------------------------------------------------
    def _execute(self) -> Table:
        return self._rolling(self.input.execute())

    @tracing.spanned("dftpu.rolling")
    def _rolling(self, t: Table) -> Table:
        cap, nb, dev = t.capacity, self.nbuckets, t.device
        alive = torch.arange(cap, device=dev) < t.nrows_dev

        dim = self.dimension.evaluate(t)
        bucket = torch.div(dim.data.to(torch.int64) - self.from_v, self.every_v, rounding_mode="floor")
        in_grid = alive & dim.valid & (bucket >= 0) & (bucket < nb)

        pcols = [e.evaluate(t) for e, _ in self.partition_by]
        if pcols:
            perm, nparts_dev, seg, kvalids, _ = group_rows(pcols, alive)
            nparts = K.learned_count(nparts_dev, self._learned, cap)
            pid = seg.gid
        else:
            perm = torch.arange(cap, device=dev)
            pid = torch.where(alive, 0, cap - 1)
            nparts_dev = nparts = 1
        nseg = nparts * nb
        cell = torch.where(in_grid[perm] & (pid < nparts), pid * nb + bucket[perm], nseg)
        cells = _Cells(cell, perm, nseg, nparts, nb)

        out_rows = nparts * nb
        out_cap = round_capacity(max(out_rows, 1))
        r = torch.arange(out_cap, device=dev)
        live = r < out_rows
        names = [n for _, n in self.partition_by]
        out_cols = []
        if pcols:
            # partition keys: each partition's first row, repeated over the grid
            src = perm[seg.first][torch.clamp(r // nb, max=max(nparts - 1, 0))]
            out_cols += K.take_columns(pcols, src, live, valids=kvalids)

        names.append(self.dim_field.name)
        grid = self.from_v + (r % nb) * self.every_v
        out_cols.append(Column(
            self.dim_field.dtype, grid.to(torch_dtype(self.dim_field.dtype.storage_np_dtype())), live,
        ))
        for ra in self.rolling_aggs:
            names.append(ra.agg.name)
            out_cols.append(_pad(self._rolling_column(ra, t, cells), out_cap, live))
        for a in self.aggs:
            names.append(a.name)
            out_cols.append(_pad(self._bucket_column(a, t, cells), out_cap, live))
        n = out_rows if isinstance(nparts_dev, int) else torch.clamp(nparts_dev, max=nparts) * nb
        return Table(names, out_cols, n, device=dev)

    # ------------------------------------------------------------------
    def _sums_counts(self, a: PhysAggExpr, t, cells, as_float):
        """[nparts, nb] per-cell sums and counts of ``a``'s argument."""
        if a.expr is None:
            ones = torch.ones(t.capacity, dtype=torch.int64, device=t.device)
            c = cells.reduce(ones, "sum")
            return c, c
        v = a.expr.evaluate(t)
        if as_float:
            x = torch.where(v.valid, to_float(v.data, v.dtype), 0.0)
        else:
            sdt = torch_dtype(a.return_type().storage_np_dtype())
            x = K.signed_view(v.data.to(sdt))
            x = torch.where(v.valid, x, torch.zeros((), dtype=x.dtype, device=x.device))
        return cells.reduce(x, "sum"), cells.reduce(v.valid.to(torch.int64), "sum")

    @staticmethod
    def _window_reduce(M, pre, post, f):
        """Reduce [nparts, nb] along the buckets over [i - pre, i + post]."""
        nb = M.shape[1]
        if f is None:  # a sum
            c = torch.cumsum(M, 1)
            b = torch.arange(nb, device=M.device)
            upper = c[:, torch.clamp(b + post, 0, nb - 1)]
            if pre is None:
                return upper
            lo = b - pre
            lower = torch.where(lo - 1 >= 0, c[:, torch.clamp(lo - 1, 0, nb - 1)],
                                torch.zeros((), dtype=c.dtype, device=c.device))
            return upper - lower
        if pre is not None or post != 0:
            raise PlanError("ROLLING min/max supports only the cumulative window")
        return (torch.cummin(M, 1) if f == "min" else torch.cummax(M, 1)).values

    def _rolling_column(self, r, t, cells):
        a = r.agg
        f = a.fun
        if f in ("sum", "count", "avg"):
            S, C = self._sums_counts(a, t, cells, f == "avg")
            Sw = self._window_reduce(S, r.preceding, r.following, None)
            Cw = self._window_reduce(C, r.preceding, r.following, None)
            out, valid = _finish(f, Sw, Cw)
            dic = None
        elif f in ("min", "max"):
            v = a.expr.evaluate(t)
            ordk = v.data if v.dtype.is_float else K.orderable_key(v.data, v.dtype)
            if v.dtype.is_float:
                neutral = float("inf") if f == "min" else float("-inf")
            else:
                info = torch.iinfo(ordk.dtype)
                neutral = info.max if f == "min" else info.min
            neutral = torch.full((), neutral, dtype=ordk.dtype, device=ordk.device)
            M = cells.reduce(torch.where(v.valid, ordk, neutral), f)
            _, C = self._sums_counts(PhysAggExpr("count", a.expr, a.name), t, cells, False)
            M = torch.where(C > 0, M, neutral)  # an empty cell holds the identity
            out = self._window_reduce(M, r.preceding, r.following, f)
            out = out.to(torch_dtype(v.dtype.storage_np_dtype()))
            valid = self._window_reduce(C, r.preceding, r.following, None) > 0
            dic = v.dictionary
        else:
            raise PlanError(f"ROLLING({f}) not supported")
        rt = a.return_type()
        return Column(rt, out.reshape(-1).to(torch_dtype(rt.storage_np_dtype())), valid.reshape(-1), dic)

    def _bucket_column(self, a, t, cells):
        f = a.fun
        if f not in ("sum", "count", "avg"):
            raise PlanError(f"GROUP BY DIMENSION aggregate '{f}' not supported (sum/count/avg)")
        out, valid = _finish(f, *self._sums_counts(a, t, cells, f == "avg"))
        rt = a.return_type()
        return Column(rt, out.reshape(-1).to(torch_dtype(rt.storage_np_dtype())), valid.reshape(-1))

    def _display_line(self):
        return (
            f"RollingWindowAggExec: dim={self.dim_field.name} "
            f"[{self.from_v}..{self.to_v}] every {self.every_v} x{self.nbuckets}"
        )


class _Cells:
    """The rows grouped by grid cell: ``cell`` holds each partition-sorted
    row's cell (``nseg`` outside the grid) and ``perm`` the partition
    sort.  ``reduce`` turns a per-row column into its [nparts, nb] per-cell
    sums, minima or maxima."""

    def __init__(self, cell, perm, nseg, nparts, nb):
        order = torch.sort(cell, stable=True).indices
        self.rows = perm[order]  # input rows in cell order
        self.sorted = cell[order]
        ords = torch.arange(nseg, device=cell.device)
        self.first = torch.searchsorted(self.sorted, ords)
        self.last = torch.searchsorted(self.sorted, ords, right=True) - 1
        self.nonempty = self.last >= self.first
        self.shape = (nparts, nb)

    def reduce(self, x, kind):
        xs = K.gather(x, self.rows)
        last = torch.clamp(self.last, min=0)
        if kind == "sum" and not xs.is_floating_point():
            run = torch.cat([xs.new_zeros(1), torch.cumsum(xs, 0)])
            out = torch.where(self.nonempty, run[self.last + 1] - run[self.first], 0)
        else:
            op = {"sum": torch.add, "min": K.xla_minimum, "max": K.xla_maximum}[kind]
            # an empty cell reads 0; its callers mask it by the cell's count
            out = torch.where(self.nonempty, K._segment_scan(xs, self.sorted, op)[last], 0)
        return out.reshape(self.shape)


def _finish(f, S, C):
    """(value, valid) of sum/count/avg from per-cell or windowed sums and
    counts."""
    if f == "count":
        return C, torch.ones(C.shape, dtype=torch.bool, device=C.device)
    if f == "sum":
        return S, C > 0
    return S / torch.clamp(C, min=1), C > 0


def _pad(c: Column, cap: int, live) -> Column:
    """The column's rows in a buffer of ``cap`` rows, those past the grid
    dead."""
    n = c.data.shape[0]
    data = torch.cat([K.signed_view(c.data), K.signed_view(c.data).new_zeros(cap - n)]).view(c.data.dtype)
    valid = torch.cat([c.valid, c.valid.new_zeros(cap - n)]) & live
    return Column(c.dtype, data, valid, c.dictionary)
