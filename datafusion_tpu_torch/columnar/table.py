"""Device-resident tables (the engine's RecordBatch equivalent).

Port of ``datafusion_tpu/columnar/table.py``.  A Table is an ordered set of
equally-sized padded Columns plus a live-row count.  Rows in
[nrows, capacity) are dead; operators mask them with
``arange(capacity) < nrows``.

The row count is lazy: it may be a 0-dim device tensor that stays on the
card until a host decision needs it, so operators that do not need the
count never wait for the device.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..errors import HostReadInWholeQuery, InternalError
from ..types import Field, Schema
from ..types.dtypes import DataType
from .column import Column, zeros_column
from .dictionary import StringDict

# count of device values read on the host: lazy row counts forced to an
# int and the reads of ``host_values`` (each one waits for the device)
HOST_SYNCS = [0]


class WholeQueryBuild(threading.local):
    """Per-thread state of a whole-query run being built
    (``physical/query_compiler.py``).  ``active``: every host read raises
    ``HostReadInWholeQuery`` (the counterpart of the error that aborts a
    JAX trace), on the CPU and on the card alike.  ``strict``: a fresh
    host-to-device copy raises too (the run is a CUDA graph capture, or
    its CPU stand-in)."""

    active = False
    strict = False


BUILD = WholeQueryBuild()


def refuse_in_whole_query(what: str) -> None:
    """Raise ``HostReadInWholeQuery(what)`` while a whole-query run is
    being built."""
    if BUILD.active:
        raise HostReadInWholeQuery(what)


def host_values(t: torch.Tensor) -> list:
    """A small device tensor's values as host Python values (waits for the
    device; counted in HOST_SYNCS)."""
    refuse_in_whole_query("reads a device value on the host")
    HOST_SYNCS[0] += 1
    with tracing.span("dftpu.sync"):
        return t.tolist()


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A device tensor copied to a host numpy array (waits for the device;
    counted in HOST_SYNCS)."""
    refuse_in_whole_query("copies a device tensor to the host")
    HOST_SYNCS[0] += 1
    with tracing.span("dftpu.sync"):
        return t.cpu().numpy()


def round_capacity(n: int) -> int:
    """Static buffer capacity for n rows: power of two, min 4096.

    Kept from the reference so that both engines pad identically."""
    if n <= 4096:
        return 4096
    return 1 << (n - 1).bit_length()


class Table:
    # the request (``tracing``) whose collect made this table
    request: int | None = None

    def __init__(self, names: list[str], columns: list[Column], nrows, device=None):
        if len(names) != len(columns):
            raise InternalError("names/columns length mismatch")
        caps = {c.capacity for c in columns}
        if len(caps) > 1:
            raise InternalError(f"ragged column capacities: {caps}")
        self.names = list(names)
        self.columns = list(columns)
        # nrows may be a 0-dim device tensor: it stays on the device until
        # some host decision actually needs the count
        self._nrows = int(nrows) if isinstance(nrows, (int, np.integer)) else nrows
        # ``device=None`` means the card here too (device.py)
        self._device = columns[0].device if columns else resolve_device(device)
        # set by a producer that sized the buffers from a learned capacity
        # (a join's or a stage's, flag-guarded): a shrink learns nothing
        self._cap_learned = False

    @property
    def nrows(self) -> int:
        if not isinstance(self._nrows, int):
            refuse_in_whole_query("reads a row count on the host")
            HOST_SYNCS[0] += 1
            with tracing.span("dftpu.sync"):
                self._nrows = int(self._nrows)
        return self._nrows

    @property
    def nrows_dev(self):
        """The live-row count without a host sync: an int when known on
        the host, else the 0-dim device tensor."""
        return self._nrows

    @property
    def device(self) -> torch.device:
        return self._device

    # ---- shape -------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else round_capacity(self.nrows)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def schema(self) -> Schema:
        return Schema(
            [Field(n, c.dtype, True) for n, c in zip(self.names, self.columns)]
        )

    def column(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    # ---- construction --------------------------------------------------------
    @staticmethod
    def from_pydict(
        data: dict, dtypes: dict[str, DataType] | None = None, device=None
    ) -> "Table":
        """Build from {name: list/np.ndarray}; infers types via pandas.
        ``device=None`` means the CUDA card."""
        dev = resolve_device(device)
        names, host = [], []
        nrows = None
        for name, values in data.items():
            cols, n = _ingest_values(values, dtypes.get(name) if dtypes else None)
            if nrows is None:
                nrows = n
            elif nrows != n:
                raise InternalError("ragged input columns")
            names.append(name)
            host.append(cols)
        nrows = nrows or 0
        cap = round_capacity(nrows)
        cols = [
            Column.from_numpy(dt, d, v, dic, capacity=cap, device=dev)
            for dt, d, v, dic in host
        ]
        return Table(names, cols, nrows, device=dev)

    @staticmethod
    def from_pandas(df, dtypes: dict[str, DataType] | None = None, device=None) -> "Table":
        """Build from a pandas DataFrame's columns (``from_pydict``)."""
        return Table.from_pydict({c: df[c].to_numpy() for c in df.columns}, dtypes=dtypes, device=device)

    @staticmethod
    def from_arrow(batch, device=None) -> "Table":
        """Ingest a pyarrow Table or RecordBatch (``ingest.py``)."""
        from .ingest import arrow_to_table

        return arrow_to_table(batch, device)

    @staticmethod
    def empty(schema: Schema, device=None) -> "Table":
        dev = resolve_device(device)
        cap = round_capacity(0)
        cols = [
            zeros_column(
                f.dtype, cap, dev, StringDict.empty() if f.dtype.is_string else None
            )
            for f in schema.fields
        ]
        return Table(schema.names(), cols, 0, device=dev)

    # ---- export ----------------------------------------------------------------
    def to_pydict(self) -> dict[str, list]:
        with tracing.span("dftpu.decode", request=self.request):
            n = self.nrows
            out = {}
            for name, c in zip(self.names, self.columns):
                with tracing.span("dftpu.decode.copy"):
                    data, valid = c.to_numpy(n)
                with tracing.span("dftpu.decode.convert"):
                    out[name] = c.numpy_to_pylist(data, valid)
            return out

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_pydict())

    def to_arrow(self):
        from .ingest import table_to_arrow

        return table_to_arrow(self)

    # ---- manipulation -------------------------------------------------------
    def shrink_to_fit(self, only_if_above: int = 0) -> "Table":
        """Right-size capacity to the live row count (live rows are
        front-compacted, so this is a slice).  Reading a lazy count waits
        for the device, so callers gate with ``only_if_above``.  No-op
        unless the capacity at least halves, and for a table whose producer
        already sized it from a learned capacity (``_cap_learned``)."""
        if self.capacity <= only_if_above:
            return self
        if self._cap_learned and not isinstance(self._nrows, int):
            return self
        newcap = round_capacity(self.nrows)  # may sync a lazy count
        if newcap * 2 > self.capacity:
            return self
        return self.with_capacity(newcap)

    def with_capacity(self, capacity: int) -> "Table":
        return Table(
            self.names,
            [c.with_capacity(capacity) for c in self.columns],
            self.nrows_dev,
            device=self._device,
        )

    def select(self, names: list[str]) -> "Table":
        cols = [self.column(n) for n in names]
        return Table(list(names), cols, self.nrows_dev, device=self._device)

    def to(self, device) -> "Table":
        """The same table on another device (a no-op when already there)."""
        dev = torch.device(device)
        if dev == self._device:
            return self
        n = self._nrows if isinstance(self._nrows, int) else self._nrows.to(dev)
        return Table(self.names, [c.to(dev) for c in self.columns], n, device=dev)

    def __repr__(self) -> str:
        return (
            f"Table[{self.nrows} rows (cap {self.capacity}), "
            + ", ".join(
                f"{n}:{c.dtype!r}" for n, c in zip(self.names, self.columns)
            )
            + "]"
        )


def _ingest_values(values, dtype: DataType | None):
    """Convert one host column (list / np array) into
    ((dtype, data, valid, dictionary), nrows) host arrays."""
    from ..types.dtypes import (
        BOOL,
        DATE32,
        FLOAT64,
        INT64,
        STRING,
        TIMESTAMP_US,
    )

    arr = np.asarray(values)
    n = len(arr)

    if dtype is not None and dtype.is_string:
        d, codes, valid = StringDict.from_strings_masked(values)
        return (dtype, codes, valid, d), n

    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        # an object array as it is (no copy into a list); one check per
        # value type, not per value
        items = arr if arr.dtype == object else list(values)
        if all(issubclass(t, str) or t is type(None) for t in set(map(type, items))):
            d, codes, valid = StringDict.from_strings_masked(items)
            return (STRING, codes, valid, d), n
        # object column of numbers with Nones
        valid = np.array([v is not None and v == v for v in items], dtype=bool)
        nums = np.array([v if ok else 0 for v, ok in zip(items, valid)], dtype=np.float64)
        dt = dtype or (
            INT64 if all(isinstance(v, (int, np.integer)) for v, ok in zip(items, valid) if ok) else FLOAT64
        )
        if dt.is_decimal:
            scaled = np.round(nums * 10**dt.scale).astype(np.int64)
            return (dt, np.where(valid, scaled, 0), valid, None), n
        return (dt, nums, valid, None), n

    if np.issubdtype(arr.dtype, np.datetime64):
        us = arr.astype("datetime64[us]").astype(np.int64)
        valid = ~np.isnat(arr)
        dt = dtype or TIMESTAMP_US
        if dt == DATE32:
            us = arr.astype("datetime64[D]").astype(np.int64)
        return (dt, np.where(valid, us, 0), valid, None), n

    if arr.dtype == np.bool_:
        return (dtype or BOOL, arr, None, None), n

    if np.issubdtype(arr.dtype, np.floating):
        valid = ~np.isnan(arr)
        dt = dtype or (FLOAT64 if arr.dtype == np.float64 else DataType("float32"))
        if dt.is_decimal:
            scaled = np.round(np.where(valid, arr, 0) * 10 ** dt.scale).astype(np.int64)
            return (dt, scaled, valid, None), n
        if dt.is_integer:
            return (dt, np.where(valid, arr, 0), valid, None), n
        return (dt, np.where(valid, arr, 0.0), valid, None), n

    if np.issubdtype(arr.dtype, np.integer):
        dt = dtype or DataType(str(arr.dtype))
        if dt.is_decimal:
            scaled = arr.astype(np.int64) * 10 ** dt.scale
            return (dt, scaled, None, None), n
        return (dt, arr, None, None), n

    raise InternalError(f"cannot ingest column of dtype {arr.dtype}")
