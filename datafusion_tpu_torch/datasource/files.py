"""File-based table providers: CSV, Parquet, NDJSON.

Port of ``datafusion_tpu/datasource/files.py``.  Reference equivalents:
- CsvFile      datafusion/src/datasource/csv.rs:51 + CsvExec
               (physical_plan/csv.rs:112)
- ParquetTable datasource/parquet.rs:36 + ParquetExec (physical_plan/
               parquet.rs:71; row-group pruning via PruningPredicate :817,
               footer metadata cache :145)
- NdJsonFile   datasource/json.rs:47 + NdJsonExec (physical_plan/json.rs:69)

The host parses and decodes: the native C++ loader (``native_lib``) for a
CSV/TBL file with a schema, pyarrow otherwise.  Ingestion converts to
fixed-width columns on the provider's device once and caches them there.
Parquet scans read only the projected columns and skip the row groups
whose min/max statistics rule out a pushed-down filter
(``physical/pruning.py``).  pyarrow is imported only where it is used:
schema inference, Parquet, JSON and the pyarrow fallback of CSV.
"""

from __future__ import annotations

import glob as _glob
import os

import numpy as np

from ..columnar.ingest import arrow_to_table, arrow_type_to_dtype, dtype_to_arrow_type
from ..columnar.table import Table
from ..device import resolve_device
from ..ops.base import ExecutionPlan
from ..ops.basic import MemoryExec, concat_tables
from ..types import Field, Schema
from .datasource import Statistics, TableProvider


def _plain_stat(v, dtype):
    """A parquet statistic in the engine's comparison domain."""
    import datetime as _dt

    if v is None:
        return None
    if isinstance(v, bytes):
        try:
            return v.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if isinstance(v, _dt.datetime):
        return int(v.timestamp() * 1_000_000)
    if isinstance(v, _dt.date):
        return (v - _dt.date(1970, 1, 1)).days
    if dtype.is_decimal:
        try:
            return int(round(float(v) * 10**dtype.scale))
        except (TypeError, ValueError):
            return None
    return v


def _expand_paths(path: str, exts: tuple[str, ...]) -> list[str]:
    if os.path.isdir(path):
        out = []
        for ext in exts:
            out += sorted(_glob.glob(os.path.join(path, f"*{ext}")))
        if not out:
            out = sorted(p for p in _glob.glob(os.path.join(path, "*")) if os.path.isfile(p))
        return out
    matches = sorted(_glob.glob(path))
    return matches if matches else [path]


class _FileTable(TableProvider):
    """Shared: lazy ingestion on first scan, cached on the device."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cache: Table | None = None

    def _read_arrow(self, columns: list[str] | None):
        raise NotImplementedError

    def _load_table(self, cols: list[str] | None) -> Table:
        """Read + ingest (CsvFile reads natively where it can)."""
        return arrow_to_table(self._read_arrow(cols), self.device)

    def scan(self, projection=None, filters=None, limit=None, table_name="") -> ExecutionPlan:
        schema = self.schema()
        want = [schema.fields[i].name for i in projection] if projection is not None else schema.names()
        if self._cache is None or not all(n in self._cache.names for n in want):
            # the first scan reads its projection; a later, wider one the file
            self._cache = self._load_table(want if self._cache is None else None)
        sub = self._cache.select(want)
        return MemoryExec(sub, sub.schema(), None, table_name=table_name)


class CsvFile(_FileTable):
    def __init__(
        self,
        path: str,
        schema: Schema | None = None,
        has_header: bool = True,
        delimiter: str = ",",
        file_extension: str = ".csv",
        device=None,
    ):
        super().__init__(device)
        self.paths = _expand_paths(path, (file_extension,))
        self.has_header = has_header
        self.delimiter = delimiter
        self._user_schema = schema
        # which loader read the file: "native" or "pyarrow"
        self.loader: str | None = None
        if schema is None:
            import pyarrow.csv as pacsv

            # inferred from the first file
            t = pacsv.read_csv(
                self.paths[0],
                read_options=pacsv.ReadOptions(autogenerate_column_names=not has_header),
                parse_options=pacsv.ParseOptions(delimiter=delimiter),
            )
            self._schema = Schema(
                [Field(n, arrow_type_to_dtype(t.schema.field(n).type), True) for n in t.schema.names]
            )
        else:
            self._schema = schema

    def schema(self) -> Schema:
        return self._schema

    def _load_table(self, cols):
        """The native C++ loader (``native_lib``); pyarrow for a type it does
        not take or where the library is not built."""
        from .. import native_lib

        parts = []
        for p in self.paths:
            t = native_lib.load_csv(p, self._schema, self.delimiter, self.has_header, self.device)
            if t is None:
                self.loader = "pyarrow"
                return super()._load_table(cols)
            parts.append(t)
        self.loader = "native"
        full = parts[0] if len(parts) == 1 else concat_tables(parts, self._schema)
        return full if cols is None else full.select(cols)

    def _read_arrow(self, columns):
        import pyarrow as pa
        import pyarrow.csv as pacsv

        col_types = names = None
        if self._user_schema is not None:
            names = [f.name for f in self._user_schema.fields]
            col_types = {f.name: dtype_to_arrow_type(f.dtype) for f in self._user_schema.fields}
        tables = []
        for p in self.paths:
            ropts = pacsv.ReadOptions(
                column_names=None if self.has_header else names,
                autogenerate_column_names=not self.has_header and names is None,
            )
            copts = pacsv.ConvertOptions(column_types=col_types, include_columns=columns)
            tables.append(pacsv.read_csv(
                p, read_options=ropts,
                parse_options=pacsv.ParseOptions(delimiter=self.delimiter),
                convert_options=copts,
            ))
        return pa.concat_tables(tables)


class ParquetTable(_FileTable):
    def __init__(self, path: str, device=None):
        super().__init__(device)
        import pyarrow.parquet as pq

        self.paths = _expand_paths(path, (".parquet", ".parq"))
        # footer metadata (schema + row-group stats), reference parquet.rs:145
        self._meta = pq.ParquetFile(self.paths[0])
        self._schema = Schema(
            [Field(f.name, arrow_type_to_dtype(f.type), f.nullable) for f in self._meta.schema_arrow]
        )

    def schema(self) -> Schema:
        return self._schema

    def statistics(self) -> Statistics:
        import pyarrow.parquet as pq

        from .datasource import ColumnStatistics

        rows = 0
        size = 0
        col_stats: dict = {}
        complete = {f.name: True for f in self._schema.fields}
        for p in self.paths:
            md = pq.ParquetFile(p).metadata
            rows += md.num_rows
            for i in range(md.num_row_groups):
                rg = md.row_group(i)
                size += rg.total_byte_size
                for ci, f in enumerate(self._schema.fields):
                    st = rg.column(ci).statistics
                    if st is None or not st.has_min_max:
                        complete[f.name] = False
                        continue
                    mn = _plain_stat(st.min, f.dtype)
                    mx = _plain_stat(st.max, f.dtype)
                    if mn is None or mx is None:
                        complete[f.name] = False
                        continue
                    cs = col_stats.setdefault(
                        f.name, ColumnStatistics(null_count=0, min_value=mn, max_value=mx)
                    )
                    cs.min_value = min(cs.min_value, mn)
                    cs.max_value = max(cs.max_value, mx)
                    if st.null_count is None or cs.null_count is None:
                        cs.null_count = None
                    else:
                        cs.null_count += st.null_count
        col_stats = {n: s for n, s in col_stats.items() if complete.get(n)}
        return Statistics(
            num_rows=rows, total_byte_size=size, is_exact=True,
            column_statistics=col_stats or None,
        )

    def _read_arrow(self, columns):
        import pyarrow as pa
        import pyarrow.parquet as pq

        return pa.concat_tables([pq.read_table(p, columns=columns) for p in self.paths])

    def supports_filter_pushdown(self, expr) -> str:
        return "inexact"  # row-group pruning; rows still re-filtered

    # ---- row-group pruning (reference parquet.rs:817 read_files +
    # physical_optimizer/pruning.rs) -------------------------------------
    def _row_group_stats(self):
        """(ContainerStats, [(path, rg_index)]) over all files' row groups.
        A decimal column's statistics are the doubles of its values, which
        is what the engine compares a filter's float literal with
        (``exprs/physical.py::_decimal_float_literal_compare``); the
        reference keeps them scaled, so a decimal filter prunes row groups
        that match (fault F14, ROADMAP.md)."""
        import pyarrow.parquet as pq

        from ..physical.pruning import ContainerStats

        groups, metas = [], []
        for p in self.paths:
            md = pq.ParquetFile(p).metadata
            for i in range(md.num_row_groups):
                groups.append((p, i))
                metas.append(md.row_group(i))
        stats = ContainerStats(len(groups))
        stats.num_rows = np.asarray([rg.num_rows for rg in metas], dtype=object)
        for ci, f in enumerate(self._schema.fields):
            mins, maxs, ncs, known = [], [], [], []
            for rg in metas:
                st = rg.column(ci).statistics
                if st is None or not st.has_min_max:
                    mins.append(None)
                    maxs.append(None)
                    ncs.append(st.null_count if st is not None else None)
                    known.append(False)
                else:
                    mn, mx = _plain_stat(st.min, f.dtype), _plain_stat(st.max, f.dtype)
                    if f.dtype.is_decimal:
                        scale = 10**f.dtype.scale
                        mn = None if mn is None else mn / scale
                        mx = None if mx is None else mx / scale
                    mins.append(mn)
                    maxs.append(mx)
                    ncs.append(st.null_count)
                    known.append(mn is not None and mx is not None)
            stats.set_column(f.name, mins, maxs, ncs, known)
        return stats, groups

    def scan(self, projection=None, filters=None, limit=None, table_name="") -> ExecutionPlan:
        if filters:
            from ..physical.pruning import PruningPredicate

            try:
                stats, groups = self._row_group_stats()
                keep = PruningPredicate(list(filters)).prune(stats)
            except Exception:  # statistics that cannot be read keep every group
                keep = None
            if keep is not None and not keep.all():
                import pyarrow as pa
                import pyarrow.parquet as pq

                cols = [self._schema.fields[i].name for i in projection] if projection is not None else None
                by_path: dict[str, list[int]] = {}
                for (p, i), k in zip(groups, keep):
                    if k:
                        by_path.setdefault(p, []).append(i)
                parts = [pq.ParquetFile(p).read_row_groups(idxs, columns=cols) for p, idxs in by_path.items()]
                if parts:
                    t = arrow_to_table(pa.concat_tables(parts), self.device)
                else:
                    sch = self._schema if projection is None else self._schema.project(projection)
                    t = Table.empty(sch, device=self.device)
                ex = MemoryExec(t, t.schema(), None, table_name=table_name)
                ex.metrics.counter("row_groups_pruned").add(int(len(groups) - keep.sum()))
                ex.metrics.counter("row_groups_matched").add(int(keep.sum()))
                return ex
        return super().scan(projection, filters, limit, table_name)


class NdJsonFile(_FileTable):
    def __init__(self, path: str, schema: Schema | None = None, device=None):
        super().__init__(device)
        self.paths = _expand_paths(path, (".json", ".ndjson", ".jsonl"))
        if schema is None:
            import pyarrow.json as pajson

            t = pajson.read_json(self.paths[0])
            self._schema = Schema([Field(f.name, arrow_type_to_dtype(f.type), True) for f in t.schema])
        else:
            self._schema = schema

    def schema(self) -> Schema:
        return self._schema

    def _read_arrow(self, columns):
        import pyarrow as pa
        import pyarrow.json as pajson

        t = pa.concat_tables([pajson.read_json(p) for p in self.paths])
        return t if columns is None else t.select(columns)
