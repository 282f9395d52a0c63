"""Fused cross-join aggregation (CrossJoinAggExec), tiled.

Port of ``datafusion_tpu/ops/joinagg.py`` (reference:
datafusion/src/cube_ext/joinagg.rs:201, CrossJoinAggExec::execute
:239-270, which folds each joined batch into accumulators so that the
|L| x |R| cross product never exists at once).

The smaller input stays whole; the larger goes through in chunks of
``TILE_ROWS // n_whole`` rows (a power of two).  A tile's [whole x chunk]
pairs come from index arithmetic and two gathers, the join condition
masks them, and:
  * one chunk: the aggregate runs over the tile's pairs under that mask;
  * several: each tile's surviving pairs move to the front of a buffer of
    a learned capacity, a partial aggregate folds them into per-group
    states, and one merge of all tiles' states gives the result.  A
    DISTINCT aggregate has no mergeable state: its tiles' survivors are
    concatenated and aggregated once.  (The reference sums the tiles'
    DISTINCT counts, which counts a value seen in two tiles twice.)
Peak memory is about one tile's pairs plus the states, not |L| x |R|.

The reference reads both row counts to choose the whole side and the
chunking, and each tile's survivor count to size it, on every run.  Here
the first run (exact) reads them and the plan keeps what they decided;
inside a speculation window later runs use the learned tiling and tile
capacities and record an overflow flag when the data outgrow them, so a
warm plan reads nothing on the host and is captured whole.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..columnar.table import Table, round_capacity
from ..types import Schema
from . import kernels as K
from .aggregate import HashAggregateExec, PhysAggExpr, merge_states
from .base import ExecutionPlan
from .basic import concat_tables

# pair rows per tile: 4M rows of float64 are 32 MiB per column
TILE_ROWS = 1 << 22


class CrossJoinAggExec(ExecutionPlan):
    """Aggregate over a condition-filtered cross join, tiled.

    group_expr/aggr_expr/condition are physical expressions over the joined
    (left fields ++ right fields) schema, as the reference plans them
    against the join schema (joinagg.rs:164-183)."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan, condition,
                 group_expr: list[tuple], aggr_expr: list[PhysAggExpr]):
        super().__init__()
        self.left = left
        self.right = right
        self.condition = condition
        self.group_expr = group_expr
        self.aggr_expr = aggr_expr
        self._single = HashAggregateExec("single", group_expr, aggr_expr, None)
        self._partial = HashAggregateExec("partial", group_expr, aggr_expr, None)
        self._distinct = any(a.distinct for a in aggr_expr)
        # what the first run's counts decided, per input capacities: the
        # tiling, each tile's survivor capacity, the output capacity
        self._learned: dict = {}

    def schema(self) -> Schema:
        return self._single.schema()

    def children(self):
        return [self.left, self.right]

    def with_new_children(self, c):
        return CrossJoinAggExec(c[0], c[1], self.condition, self.group_expr, self.aggr_expr)

    # ------------------------------------------------------------------
    def _tiling(self, lt: Table, rt: Table, key):
        """(whole side is the left, whole rows, chunk rows, chunks)."""
        learned = self._learned.get(("tiling", key))
        ln, rn = lt.nrows_dev, rt.nrows_dev
        if learned is not None and K.spec_active() and not (isinstance(ln, int) and isinstance(rn, int)):
            whole_is_left, n_whole, cc, nchunks = learned
            nw, nb = (ln, rn) if whole_is_left else (rn, ln)
            over = (nw > n_whole) | (nb > nchunks * cc)
            if isinstance(over, torch.Tensor):
                K.spec_record(over)
                return learned
            if not over:
                return learned
        ln, rn = lt.nrows, rt.nrows  # the reference's reads (:93)
        whole_is_left = ln <= rn
        n_whole = max(min(ln, rn), 1)
        big_cap = (rt if whole_is_left else lt).capacity
        # chunk rows: a power of two, at least 128, at most the big side
        per = max(1, TILE_ROWS // n_whole)
        cc = max(128, min(1 << (per.bit_length() - 1), big_cap))
        nchunks = max(1, -(-max(ln, rn) // cc))
        tiling = (whole_is_left, n_whole, cc, nchunks)
        self._learned[("tiling", key)] = tiling
        return tiling

    def _execute(self) -> Table:
        lt = self.left.execute()
        rt = self.right.execute()
        key = (lt.capacity, rt.capacity)
        whole_is_left, n_whole, cc, nchunks = self._tiling(lt, rt, key)
        whole, big = (lt, rt) if whole_is_left else (rt, lt)
        self.metrics.counter("tiles").add(nchunks)
        out_cap = round_capacity(n_whole * cc)
        dev = lt.device
        r = torch.arange(out_cap, device=dev)
        wi = torch.clamp(r // cc, max=whole.capacity - 1)
        ki = r % cc
        in_whole = r // cc < whole.nrows_dev

        tiles = []
        for ci in range(nchunks):
            start = ci * cc
            nb = big.nrows_dev
            in_chunk = min(max(nb - start, 0), cc) if isinstance(nb, int) else torch.clamp(nb - start, 0, cc)
            alive = in_whole & (ki < in_chunk)
            view = self._pairs(lt, rt, whole_is_left, wi, ki, start, cc, alive)
            keep = alive
            if self.condition is not None:
                pred = self.condition.evaluate(view)
                keep = keep & pred.data.to(torch.bool) & pred.valid
            if nchunks == 1:
                self.lazy_metric("matched_rows", keep.sum())
                out = self._single.aggregate(view, keep)
                return K.fit_learned(out, self._learned, ("out", key))
            tiles.append(self._compact(view, keep, ("tile", key, ci)))

        if self._distinct:
            # no mergeable state: the survivors of every tile, aggregated once
            merged = concat_tables(tiles, view.schema())
            out = self._single.aggregate(merged, torch.arange(merged.capacity, device=dev) < merged.nrows_dev)
        else:
            states = [
                self._partial.aggregate(t, torch.arange(t.capacity, device=dev) < t.nrows_dev)
                for t in tiles
            ]
            cat = Table(
                states[0].names,
                [Column(c.dtype, torch.cat([s.columns[j].data for s in states]),
                        torch.cat([s.columns[j].valid for s in states]), c.dictionary)
                 for j, c in enumerate(states[0].columns)],
                0, device=dev,
            )
            alive = torch.cat([torch.arange(s.capacity, device=dev) < s.nrows_dev for s in states])
            out = merge_states(self._partial, cat, alive)
        return K.fit_learned(out, self._learned, ("out", key))

    def _pairs(self, lt, rt, whole_is_left, wi, ki, start, cc, alive) -> Table:
        """The tile's pairs as a table over the joined schema: pair r joins
        whole row ``wi[r]`` with big row ``start + ki[r]``."""
        whole, big = (lt, rt) if whole_is_left else (rt, lt)
        w_cols = K.take_columns(whole.columns, wi, alive)
        b_cols = K.take_columns([Column(c.dtype, c.data[start:start + cc], c.valid[start:start + cc],
                                        c.dictionary) for c in big.columns], ki, alive)
        cols = w_cols + b_cols if whole_is_left else b_cols + w_cols
        return Table(list(lt.names) + list(rt.names), cols, 0, device=lt.device)

    def _compact(self, view: Table, keep, key) -> Table:
        """The tile's surviving pairs at the front of buffers of a learned
        capacity (the first run reads the count, as the reference does per
        tile at :127)."""
        cnt = keep.sum()
        self.lazy_metric("matched_rows", cnt)
        cap = K.learned_count(cnt, self._learned, key, round_capacity)
        idx = K.keep_index(keep, cap)
        live = torch.arange(cap, device=keep.device) < cnt
        cols = K.take_columns(view.columns, idx, live)
        return Table(view.names, cols, torch.clamp(cnt, max=cap), device=view.device)

    def _display_line(self):
        return (
            f"CrossJoinAggExec: on {self.condition!r}, "
            f"group={[n for _, n in self.group_expr]}, aggr={self.aggr_expr}"
        )
