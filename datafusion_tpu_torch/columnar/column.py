"""Device-resident columns: structure-of-arrays with validity masks.

Port of ``datafusion_tpu/columnar/column.py``: ``data`` is a torch tensor
of the type's storage dtype and ``valid`` a bool tensor, both on the
table's device.  Strings carry a host-side sorted StringDict (see
dictionary.py).  Buffers are padded to a static capacity; the live-row
count is tracked by the owning Table.  A fixed-size list column of k
elements (``array(...)``) has data of shape (capacity, k), whose element
nulls are in-band sentinels (``list_null_sentinel``), so every row
gather, sort and compaction carries them along.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device, torch_dtype
from ..types.dtypes import DataType
from .dictionary import StringDict


def list_null_sentinel(elem: DataType):
    """In-band null sentinel for fixed-size-list ELEMENTS: NaN for floats,
    INT_MIN for integer-backed types, code -1 for dictionary strings."""
    st = elem.storage_np_dtype()
    if np.issubdtype(st, np.floating):
        return st.type(np.nan)
    if elem.is_string:
        return np.int32(-1)
    if st == np.bool_:
        return np.bool_(False)  # bool lists: nulls collapse to false
    return st.type(np.iinfo(st).min)


def list_element_valid(elem: DataType, data: np.ndarray) -> np.ndarray:
    """Element-validity mask recovered from the in-band sentinels."""
    st = elem.storage_np_dtype()
    if np.issubdtype(st, np.floating):
        return ~np.isnan(data)
    if elem.is_string:
        return data >= 0
    if st == np.bool_:
        return np.ones(data.shape, bool)
    return data != np.iinfo(st).min


# days from 1970-01-01 to datetime.date's first and last day
_DAY_MIN = (_dt.date.min - _dt.date(1970, 1, 1)).days
_DAY_MAX = (_dt.date.max - _dt.date(1970, 1, 1)).days
# microseconds from the epoch within which float seconds (``v / 1e6``, as
# ``datetime.fromtimestamp`` takes them) are off by under half a microsecond,
# so they round back to ``v``
_US_EXACT = 2**32 * 10**6


def _in_range(data: np.ndarray, live: np.ndarray, lo: int, hi: int) -> bool:
    """Whether every live value lies in [lo, hi]."""
    v = data[live]
    return not v.size or (int(v.min()) >= lo and int(v.max()) <= hi)


def _values(dtype: DataType, dictionary, data: np.ndarray, live: np.ndarray):
    """(vals, exact): an array whose ``.tolist()`` gives each live row's
    Python value (anything at the other rows), built by whole-column numpy
    conversions; ``exact`` where a column's values are out of their range
    and the array was built value by value, as Python computes them."""
    if dtype.is_string:
        assert dictionary is not None
        return dictionary.decode(data), False
    if dtype.is_decimal:
        scale = 10**dtype.scale
        # both operands exact in float64: IEEE division rounds the quotient
        # as Python's int / int does
        if dtype.scale <= 22 and _in_range(data, live, -(2**53), 2**53):
            return data.astype(np.float64) / float(scale), False
        return np.array([v / scale for v in data.tolist()], dtype=np.float64), True
    if dtype.kind == "date32":
        if _in_range(data, live, _DAY_MIN, _DAY_MAX):
            days, inv = np.unique(data, return_inverse=True)
            return days.astype("datetime64[D]").astype(object)[inv], False
        epoch = _dt.date(1970, 1, 1)
        return _per_live(data, live, lambda v: epoch + _dt.timedelta(days=v)), True
    if dtype.kind == "timestamp":
        if _in_range(data, live, 1 - _US_EXACT, _US_EXACT - 1):
            return data.astype("datetime64[us]").astype(object), False
        utc = _dt.timezone.utc
        return _per_live(
            data, live, lambda v: _dt.datetime.fromtimestamp(v / 1e6, tz=utc).replace(tzinfo=None)
        ), True
    # ints, uints, intervals, the null type, floats (float32 widened), bools
    return data, False


def _per_live(data: np.ndarray, live: np.ndarray, fn) -> np.ndarray:
    """An object array of ``fn(int(v))`` at the live rows."""
    out = np.empty(len(data), dtype=object)
    for i in np.flatnonzero(live).tolist():
        out[i] = fn(int(data[i]))
    return out


def _with_nulls(vals: np.ndarray, valid: np.ndarray) -> list:
    """``vals.tolist()`` with None at the rows ``valid`` clears."""
    if valid.all():
        return vals.tolist()
    out = vals.astype(object)
    out[~valid] = None
    return out.tolist()


@dataclass
class Column:
    """One column: device data + device validity + logical type (+ dict)."""

    dtype: DataType
    data: torch.Tensor  # shape (capacity,), storage dtype; lists: (capacity, k)
    valid: torch.Tensor  # shape (capacity,), bool
    dictionary: StringDict | None = None  # strings only
    # host-known constant value when the column came from a literal; lets
    # host-side decisions (decimal-vs-float literal compares) read the
    # value without touching device data
    literal: object = None
    # host-known (min, max) of the live values for 64-bit integer-backed
    # columns, recorded at ingest.  A hint only: when the range fits int32,
    # sort keys run at 32-bit width (kernels.orderable_key)
    vrange: tuple | None = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_numpy(
        dtype: DataType,
        data: np.ndarray,
        valid: np.ndarray | None = None,
        dictionary: StringDict | None = None,
        capacity: int | None = None,
        device=None,
    ) -> "Column":
        n = len(data)
        cap = capacity if capacity is not None else n
        storage = dtype.storage_np_dtype()
        buf = np.zeros((cap,) + np.shape(data)[1:], dtype=storage)
        buf[:n] = data.astype(storage, copy=False)
        v = np.zeros(cap, dtype=bool)
        if valid is None:
            v[:n] = True
        else:
            v[:n] = valid
        vrange = None
        if buf.ndim == 1 and storage.kind in "iu" and storage.itemsize == 8 and n > 0:
            live = buf[:n][v[:n]]
            if live.size:
                vrange = (int(live.min()), int(live.max()))
        dev = resolve_device(device)
        return Column(
            dtype,
            torch.from_numpy(buf).to(dev),
            torch.from_numpy(v).to(dev),
            dictionary,
            vrange=vrange,
        )

    def to_numpy(self, nrows: int) -> tuple[np.ndarray, np.ndarray]:
        """(data, valid) for the first ``nrows`` live rows, as numpy."""
        return (
            self.data[:nrows].cpu().numpy(),
            self.valid[:nrows].cpu().numpy(),
        )

    def to_pylist(self, nrows: int) -> list:
        """Decode to Python values (strings decoded, decimals rescaled)."""
        return self.numpy_to_pylist(*self.to_numpy(nrows))

    def numpy_to_pylist(self, data: np.ndarray, valid: np.ndarray) -> list:
        """``to_pylist`` of the rows ``to_numpy`` copied to the host, built
        a whole column at a time (``_values``)."""
        if not self.dtype.is_list:
            vals, exact = _values(self.dtype, self.dictionary, data, valid)
            rows = _with_nulls(vals, valid)
        else:
            # element nulls are in-band sentinels, decoded per element
            # position (reference array() -> FixedSizeList,
            # array_expressions.rs:63)
            ev = list_element_valid(self.dtype.elem, data)
            out = np.empty(data.shape, dtype=object)
            exact = False
            for j in range(data.shape[1]):
                vals, e = _values(self.dtype.elem, self.dictionary, data[:, j], ev[:, j] & valid)
                out[:, j] = vals
                exact |= e
            out[~ev] = None
            rows = out.tolist()
            if not valid.all():
                rows = [r if ok else None for r, ok in zip(rows, valid.tolist())]
        if exact:
            tracing.count("dftpu.decode.exact")
        return rows

    def with_capacity(self, capacity: int) -> "Column":
        """Grow/shrink padding to a new static capacity."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity > cap:
            pad = capacity - cap
            data = torch.cat([self.data, self.data.new_zeros((pad,) + self.data.shape[1:])])
            valid = torch.cat([self.valid, self.valid.new_zeros(pad)])
        else:
            data = self.data[:capacity]
            valid = self.valid[:capacity]
        return Column(self.dtype, data, valid, self.dictionary, vrange=self.vrange)

    def to(self, device) -> "Column":
        return Column(
            self.dtype,
            self.data.to(device),
            self.valid.to(device),
            self.dictionary,
            self.literal,
            self.vrange,
        )


def zeros_column(dtype: DataType, capacity: int, device, dictionary=None) -> Column:
    """An all-NULL column of ``capacity`` rows."""
    shape = (capacity, dtype.list_size) if dtype.is_list else (capacity,)
    return Column(
        dtype,
        torch.zeros(shape, dtype=torch_dtype(dtype.storage_np_dtype()), device=device),
        torch.zeros(capacity, dtype=torch.bool, device=device),
        dictionary,
    )
