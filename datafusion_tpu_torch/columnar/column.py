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
        """``to_pylist`` of the rows ``to_numpy`` copied to the host."""
        nrows = len(valid)
        if self.dtype.is_list:
            # element nulls are in-band sentinels, decoded per element
            # position (reference array() -> FixedSizeList,
            # array_expressions.rs:63)
            k = self.dtype.list_size
            ev = list_element_valid(self.dtype.elem, data)
            elems = [
                Column(
                    self.dtype.elem,
                    torch.from_numpy(np.ascontiguousarray(data[:, j])),
                    torch.from_numpy(np.ascontiguousarray(ev[:, j])),
                    self.dictionary,
                ).to_pylist(nrows)
                for j in range(k)
            ]
            if not k:
                return [[] if ok else None for ok in valid]
            return [list(vals) if ok else None for vals, ok in zip(zip(*elems), valid)]
        if self.dtype.is_string:
            assert self.dictionary is not None
            vals = self.dictionary.decode(data)
            return [v if ok else None for v, ok in zip(vals, valid)]
        if self.dtype.is_decimal:
            scale = 10 ** self.dtype.scale
            return [int(v) / scale if ok else None for v, ok in zip(data, valid)]
        if self.dtype.kind == "date32":
            epoch = _dt.date(1970, 1, 1)
            return [
                epoch + _dt.timedelta(days=int(v)) if ok else None
                for v, ok in zip(data, valid)
            ]
        if self.dtype.kind == "timestamp":
            return [
                _dt.datetime.fromtimestamp(int(v) / 1e6, tz=_dt.timezone.utc).replace(tzinfo=None)
                if ok
                else None
                for v, ok in zip(data, valid)
            ]
        if self.dtype.is_bool:
            return [bool(v) if ok else None for v, ok in zip(data, valid)]
        if self.dtype.is_float:
            return [float(v) if ok else None for v, ok in zip(data, valid)]
        return [v.item() if ok else None for v, ok in zip(data, valid)]

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
