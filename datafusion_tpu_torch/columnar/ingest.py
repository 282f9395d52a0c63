"""Arrow interop: pyarrow Table/RecordBatch <-> Table.

Port of ``datafusion_tpu/columnar/ingest.py``.  Variable-width data is
handled here, once, at the host boundary: strings become sorted-dictionary
codes, decimals scaled int64, temporals epoch-relative integers.  The
device only ever sees fixed-width buffers.

pyarrow is imported inside the functions that use it: it may be missing
where the engine runs (a CSV with a schema loads without it, through
``native_lib``).
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..errors import InternalError
from ..types.dtypes import (
    BOOL,
    DATE32,
    FLOAT32,
    FLOAT64,
    INT8,
    INT16,
    INT32,
    INT64,
    STRING,
    TIMESTAMP_US,
    UINT8,
    UINT16,
    UINT32,
    UINT64,
    DataType,
    decimal,
)
from .column import Column
from .dictionary import StringDict
from .table import Table, round_capacity


def _pa_to_dt() -> dict:
    import pyarrow as pa

    return {
        pa.bool_(): BOOL,
        pa.int8(): INT8,
        pa.int16(): INT16,
        pa.int32(): INT32,
        pa.int64(): INT64,
        pa.uint8(): UINT8,
        pa.uint16(): UINT16,
        pa.uint32(): UINT32,
        pa.uint64(): UINT64,
        pa.float32(): FLOAT32,
        pa.float64(): FLOAT64,
        pa.date32(): DATE32,
    }


def arrow_type_to_dtype(t) -> DataType:
    import pyarrow as pa

    known = _pa_to_dt()
    if t in known:
        return known[t]
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return STRING
    if pa.types.is_dictionary(t):
        return STRING
    if pa.types.is_timestamp(t):
        return TIMESTAMP_US
    if pa.types.is_decimal(t):
        return decimal(t.precision, t.scale)
    if pa.types.is_date64(t):
        return DATE32
    raise InternalError(f"unsupported arrow type {t}")


def dtype_to_arrow_type(dt: DataType):
    import pyarrow as pa

    for k, v in _pa_to_dt().items():
        if v == dt:
            return k
    if dt.is_string:
        return pa.string()
    if dt == TIMESTAMP_US:
        return pa.timestamp("us")
    if dt.is_decimal:
        return pa.decimal128(max(dt.precision, 1), dt.scale)
    raise InternalError(f"unsupported dtype {dt}")


def arrow_column_to_numpy(arr):
    """Host-side conversion: an arrow column -> (dtype, np data, np valid,
    dictionary).  No device transfer: host-resident tables ingest through
    this directly."""
    import pyarrow as pa

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    dt = arrow_type_to_dtype(arr.type)
    valid = np.asarray(arr.is_valid())

    if dt.is_string:
        if pa.types.is_dictionary(arr.type):
            arr = arr.cast(pa.string())
        d, codes = StringDict.from_strings(arr.to_pylist())
        return dt, codes, valid, d

    if dt.is_decimal:
        # the unscaled values are the low words of the 128-bit storage
        # (exact; the reference rounds float(v) * 10**scale, the same below
        # 2**53)
        words = np.frombuffer(arr.buffers()[1], dtype="<i8")
        data = words[2 * arr.offset: 2 * (arr.offset + len(arr)): 2]
        return dt, np.where(valid, data, 0), valid, None

    if dt == TIMESTAMP_US:
        data = arr.cast(pa.timestamp("us")).to_numpy(zero_copy_only=False)
        data = data.astype("datetime64[us]").astype(np.int64)
        return dt, np.where(valid, data, 0), valid, None

    if dt == DATE32:
        data = arr.cast(pa.date32()).to_numpy(zero_copy_only=False)
        data = data.astype("datetime64[D]").astype(np.int64)
        return dt, np.where(valid, data, 0), valid, None

    data = arr.to_numpy(zero_copy_only=False)
    if data.dtype == object or np.issubdtype(data.dtype, np.floating) and dt.is_integer:
        data = np.array([v if v is not None else 0 for v in arr.to_pylist()])
    if np.issubdtype(data.dtype, np.floating) and dt.is_float:
        data = np.where(valid, data, 0.0)
    return dt, data, valid, None


def arrow_to_table(t, device=None) -> Table:
    """A pyarrow Table or RecordBatch as a Table on ``device`` (None: the
    CUDA card)."""
    dev = resolve_device(device)
    cap = round_capacity(t.num_rows)
    cols = []
    for i in range(len(t.schema.names)):
        dt, data, valid, d = arrow_column_to_numpy(t.column(i))
        cols.append(Column.from_numpy(dt, data, valid, d, capacity=cap, device=dev))
    return Table(list(t.schema.names), cols, t.num_rows, device=dev)


def table_to_arrow(t: Table):
    """The live rows as a pyarrow Table, built from whole columns."""
    import pyarrow as pa

    n = t.nrows
    arrays, fields = [], []
    for name, col in zip(t.names, t.columns):
        patype = dtype_to_arrow_type(col.dtype)
        data, valid = col.to_numpy(n)
        if col.dtype.is_decimal:
            # 128-bit two's complement words: the value, then its sign
            v = data.astype(np.int64)
            words = np.stack([v, v >> 63], axis=1).astype("<i8")
            bitmap = pa.py_buffer(np.packbits(valid, bitorder="little"))
            arr = pa.Array.from_buffers(patype, n, [bitmap, pa.py_buffer(words.tobytes())])
        elif col.dtype.is_string:
            vals = np.asarray(col.dictionary.values, dtype=object)
            codes = np.clip(data.astype(np.int64), 0, max(len(vals) - 1, 0))
            arr = pa.array(vals[codes] if len(vals) else np.full(n, "", object), type=patype, mask=~valid)
        elif col.dtype == DATE32:
            arr = pa.array(data.astype(np.int32), type=pa.int32(), mask=~valid).cast(patype)
        elif col.dtype == TIMESTAMP_US:
            arr = pa.array(data.astype(np.int64), type=pa.int64(), mask=~valid).cast(patype)
        else:
            arr = pa.array(data, type=patype, mask=~valid)
        arrays.append(arr)
        fields.append(pa.field(name, patype))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))
