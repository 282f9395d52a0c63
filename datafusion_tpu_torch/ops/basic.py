"""Basic physical operators: scan, projection, filter, limit/skip, union,
empty, explain.

Port of ``datafusion_tpu/ops/basic.py``.  Reference equivalents:
- MemoryExec      (datafusion/src/physical_plan/memory.rs:39)
- ProjectionExec  (projection.rs:45)
- FilterExec      (filter.rs:48)  -> mask + stable-sort compaction
- GlobalLimitExec (limit.rs:44) -> row-count clamp (live rows are always
  compacted to the front, so LIMIT is O(1))
- SkipExec        (fork OFFSET, skip.rs:41) -> left shift of the live rows
- UnionExec       (union.rs:34) -> concatenation + dictionary merge
- EmptyExec/ExplainExec (empty.rs:37, explain.rs:38)
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dictionary import StringDict
from ..columnar.table import Table, round_capacity
from ..exprs.physical import PhysicalExpr, cast_column, device_table
from ..types import Field, Schema
from ..types.dtypes import STRING
from . import kernels as K
from .base import ExecutionPlan


def clamp_rows(n, k: int):
    """min(n, k) for a host int or a 0-dim device count."""
    return min(n, k) if isinstance(n, int) else torch.clamp(n, max=k)


class MemoryExec(ExecutionPlan):
    def __init__(
        self,
        table: Table,
        schema: Schema,
        projection: list[int] | None = None,
        table_name: str = "",
    ):
        super().__init__()
        self.table = table
        self._schema = schema
        self.projection = projection
        self.table_name = table_name

    def schema(self):
        if self.projection is None:
            return self._schema
        return self._schema.project(self.projection)

    def with_new_children(self, c):
        return self

    def _execute(self) -> Table:
        t = self.table
        if self.projection is not None:
            names = [t.names[i] for i in self.projection]
            t = t.select(names)
        return t

    def _display_line(self):
        return f"MemoryExec: {self.table.nrows} rows"


class ProjectionExec(ExecutionPlan):
    def __init__(self, exprs: list[tuple[PhysicalExpr, str]], input: ExecutionPlan):
        super().__init__()
        self.exprs = exprs
        self.input = input

    def schema(self):
        return Schema([Field(name, e.dtype, True) for e, name in self.exprs])

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return ProjectionExec(self.exprs, c[0])

    def _execute(self) -> Table:
        t = self.input.execute()
        cols = [e.evaluate(t) for e, _ in self.exprs]
        names = [name for _, name in self.exprs]
        return Table(names, cols, t.nrows_dev, device=t.device)

    def _display_line(self):
        return f"ProjectionExec: {[n for _, n in self.exprs]}"


class FilterExec(ExecutionPlan):
    def __init__(self, predicate: PhysicalExpr, input: ExecutionPlan):
        super().__init__()
        self.predicate = predicate
        self.input = input

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return FilterExec(self.predicate, c[0])

    def _execute(self) -> Table:
        t = self.input.execute()
        pred = self.predicate.evaluate(t)
        keep = pred.data.to(torch.bool) & pred.valid
        datas = tuple(c.data for c in t.columns)
        valids = tuple(c.valid for c in t.columns)
        d2, v2, cnt = K.filter_compact(datas, valids, keep, t.nrows_dev)
        cols = [
            Column(c.dtype, d, v, c.dictionary)
            for c, d, v in zip(t.columns, d2, v2)
        ]
        # the count stays on the device (the capacity is unchanged)
        return Table(t.names, cols, cnt, device=t.device)

    def _display_line(self):
        return f"FilterExec: {self.predicate!r}"


class GlobalLimitExec(ExecutionPlan):
    def __init__(self, n: int, input: ExecutionPlan):
        super().__init__()
        self.n = n
        self.input = input

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return GlobalLimitExec(self.n, c[0])

    def _execute(self) -> Table:
        t = self.input.execute()
        return Table(t.names, t.columns, clamp_rows(t.nrows_dev, self.n), device=t.device)

    def _display_line(self):
        return f"GlobalLimitExec: {self.n}"


class SkipExec(ExecutionPlan):
    """OFFSET (fork's skip.rs:41): shift live rows left by n."""

    def __init__(self, n: int, input: ExecutionPlan):
        super().__init__()
        self.n = n
        self.input = input

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return SkipExec(self.n, c[0])

    def _execute(self) -> Table:
        t = self.input.execute()
        n = min(self.n, t.nrows)
        if n == 0:
            return t
        cols = []
        for c in t.columns:
            data = torch.cat([c.data[n:], c.data.new_zeros(n)])
            valid = torch.cat([c.valid[n:], c.valid.new_zeros(n)])
            cols.append(Column(c.dtype, data, valid, c.dictionary))
        return Table(t.names, cols, t.nrows - n, device=t.device)

    def _display_line(self):
        return f"SkipExec: {self.n}"


class UnionExec(ExecutionPlan):
    def __init__(self, inputs: list[ExecutionPlan], schema: Schema):
        super().__init__()
        self.inputs = inputs
        self._schema = schema

    def schema(self):
        return self._schema

    def children(self):
        return list(self.inputs)

    def with_new_children(self, c):
        return UnionExec(list(c), self._schema)

    def _execute(self) -> Table:
        return concat_tables([i.execute() for i in self.inputs], self._schema)

    def _display_line(self):
        return "UnionExec"


def concat_tables(tables: list[Table], schema: Schema) -> Table:
    """Concatenate the live rows of several tables into one compacted
    table, casting to the target schema and merging string dictionaries.

    No host sync: the pieces are joined at their full capacities and one
    compaction moves the live rows to the front (the reference writes each
    piece at a traced offset instead)."""
    dev = tables[0].device
    keep = torch.cat([
        torch.arange(t.capacity, device=dev) < t.nrows_dev for t in tables
    ])
    out_cap = round_capacity(keep.shape[0])
    keep = torch.cat([keep, keep.new_zeros(out_cap - keep.shape[0])])
    datas, valids, dictionaries = [], [], []
    for i, f in enumerate(schema.fields):
        pieces = [cast_column(t.columns[i], f.dtype) for t in tables]
        merged = None
        if f.dtype.is_string:
            pieces, merged = _merge_dictionaries(pieces)
        data = torch.cat([p.data for p in pieces])
        valid = torch.cat([p.valid for p in pieces])
        pad = out_cap - data.shape[0]
        datas.append(torch.cat([data, data.new_zeros(pad)]))
        valids.append(torch.cat([valid, valid.new_zeros(pad)]))
        dictionaries.append(merged)
    out_d, out_v, total = K.filter_compact(tuple(datas), tuple(valids), keep, out_cap)
    cols = [
        Column(f.dtype, d, v, dic)
        for f, dic, d, v in zip(schema.fields, dictionaries, out_d, out_v)
    ]
    return Table(schema.names(), cols, total, device=dev)


# a union's merged dictionary and remap tables per tuple of input
# dictionaries: one identity from run to run, so a warm run copies no
# table from the host (exprs/physical.py::device_table)
_UNION_MERGES: dict = {}


def _merge_dictionaries(pieces: list[Column]):
    """The pieces of one string column remapped onto one sorted dictionary
    (no remap when they already share one)."""
    live = [p.dictionary for p in pieces if p.dictionary is not None and len(p.dictionary) > 0]
    distinct = {id(d): d for d in live}
    if len(distinct) <= 1:
        merged = live[0] if live else StringDict.empty()
        return [Column(STRING, p.data, p.valid, merged) for p in pieces], merged
    key = tuple(distinct)
    hit = _UNION_MERGES.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], distinct.values())):
        all_vals = np.unique(np.concatenate([d.values.astype(str) for d in distinct.values()]))
        remaps = {
            i: np.searchsorted(all_vals, d.values.astype(str)).astype(np.int32)
            for i, d in distinct.items()
        }
        if len(_UNION_MERGES) > 4096:
            _UNION_MERGES.clear()
        hit = _UNION_MERGES[key] = (
            tuple(distinct.values()), StringDict(all_vals.astype(object)), remaps
        )
    _, merged, remaps = hit
    out = []
    for p in pieces:
        data = p.data
        if p.dictionary is not None and len(p.dictionary) > 0:
            remap = remaps[id(p.dictionary)]
            idx = torch.clamp(p.data, 0, len(remap) - 1).to(torch.int64)
            data = device_table(remap, p.data.device)[idx]
        out.append(Column(STRING, data, p.valid, merged))
    return out, merged


class EmptyExec(ExecutionPlan):
    def __init__(self, schema: Schema, produce_one_row: bool = False, device=None):
        super().__init__()
        self._schema = schema
        self.produce_one_row = produce_one_row
        self.device = device

    def schema(self):
        return self._schema

    def with_new_children(self, c):
        return self

    def _execute(self) -> Table:
        t = Table.empty(self._schema, device=self.device)
        if self.produce_one_row:
            # one all-null row
            return Table(t.names, t.columns, 1, device=t.device)
        return t

    def _display_line(self):
        return f"EmptyExec: one_row={self.produce_one_row}"


class ExplainExec(ExecutionPlan):
    def __init__(self, schema: Schema, rows: list[tuple[str, str]], device=None):
        super().__init__()
        self._schema = schema
        self.rows = rows
        self.device = device

    def schema(self):
        return self._schema

    def with_new_children(self, c):
        return self

    def _execute(self) -> Table:
        return Table.from_pydict(
            {
                "plan_type": [r[0] for r in self.rows],
                "plan": [r[1] for r in self.rows],
            },
            device=self.device,
        )

    def _display_line(self):
        return "ExplainExec"
