"""Host-resident tables streamed to the device in morsels.

Port of ``datafusion_tpu/datasource/host.py``.  The reference's scans
stream batches from disk on a reader thread, so no table ever has to fit
in memory (datafusion/src/physical_plan/parquet.rs:596-636).  Here a table
too big for the card stays in host memory as numpy columns, and fused
stages run per MORSEL, a fixed-capacity device slice of it, with partial
aggregates merged at the end (``physical/morsel.py``).  Every morsel has
one shape, so every morsel runs the same operators at the same capacity.

On the card the columns sit in pinned (page-locked) host memory, pinned
once when the table is made or moved to the card (``pin_seconds``): a
copy from pageable memory is synchronous whatever ``non_blocking`` says,
while a copy from pinned memory runs on a copy engine beside the kernels.
A morsel's columns are then views of the pinned buffers, copied straight
into one device staging buffer per loop; ``stream_morsels``
(``MorselStream``) issues morsel i+1's copies on a side stream before the
caller computes on morsel i, and hands each morsel over in a fresh buffer
or in the loop's static one, which a CUDA graph of the morsel's work reads
(``physical/morsel.py``).  The rows past the last morsel's end are zeroed
on the device.

``HostMemoryExec`` is a ``MemoryExec``, so a consumer that needs the
whole table (a join whose probe cannot stream, the distributed planner)
materializes it on the device once (``materialize``, cached); only the
fused-stage paths of ``physical/fuse.py`` stream.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import tracing
from ..columnar.column import Column
from ..columnar.dictionary import StringDict
from ..columnar.table import Schema, Table, host_numpy, round_capacity
from ..device import resolve_device, torch_dtype
from ..errors import InternalError
from ..ops.base import ExecutionPlan
from ..ops.basic import MemoryExec
from ..types import Field
from ..types.dtypes import DataType
from .datasource import Statistics, TableProvider

DEFAULT_MORSEL_ROWS = 1 << 20

# per card: the stream that morsel copies run on
_COPY_STREAMS: dict = {}


class HostTable:
    """Columns as numpy arrays in host memory (pinned on the card); the
    device sees one morsel at a time, or the whole table once
    (``materialize``).  ``device=None`` means the CUDA card."""

    def __init__(
        self,
        names: list[str],
        dtypes: list[DataType],
        datas: list[np.ndarray],
        valids: list[np.ndarray | None],
        dicts: list[StringDict | None],
        nrows: int,
        morsel_rows: int = DEFAULT_MORSEL_ROWS,
        device=None,
    ):
        self.names = list(names)
        self.dtypes = list(dtypes)
        self.dicts = list(dicts)
        self.nrows = int(nrows)
        self.morsel_rows = int(morsel_rows)
        self.device = resolve_device(device)
        # storage dtypes, contiguous and writable (torch wraps them); a
        # missing mask means all rows valid
        self.datas = [_host_array(d[: self.nrows], dt.storage_np_dtype()) for dt, d in zip(self.dtypes, datas)]
        self.valids = [
            np.ones(self.nrows, bool) if v is None else _host_array(v[: self.nrows], np.bool_)
            for v in valids
        ]
        self.pin_seconds = 0.0
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            self.datas = [_pinned(d) for d in self.datas]
            self.valids = [_pinned(v) for v in self.valids]
            self.pin_seconds = time.perf_counter() - t0
        self._materialized: Table | None = None

    # ---- construction ------------------------------------------------------
    @staticmethod
    def from_table(t: Table, morsel_rows: int = DEFAULT_MORSEL_ROWS, device=None) -> "HostTable":
        """A device Table copied to host memory, kept for ``device`` (None:
        the table's own device)."""
        n = t.nrows
        return HostTable(
            list(t.names),
            [c.dtype for c in t.columns],
            [host_numpy(c.data[:n]) for c in t.columns],
            [host_numpy(c.valid[:n]) for c in t.columns],
            [c.dictionary for c in t.columns],
            n,
            morsel_rows,
            t.device if device is None else device,
        )

    @staticmethod
    def from_pydict(data: dict, dtypes=None, morsel_rows: int = DEFAULT_MORSEL_ROWS,
                    device=None) -> "HostTable":
        """Ingest on the host through ``Table.from_pydict`` and keep the
        host copies."""
        t = Table.from_pydict(data, dtypes=dtypes, device="cpu")
        return HostTable.from_table(t, morsel_rows, resolve_device(device))

    @staticmethod
    def from_arrow(t, morsel_rows: int = DEFAULT_MORSEL_ROWS, device=None) -> "HostTable":
        """A pyarrow Table or RecordBatch as a HostTable, with no device
        transfer: the file stays in host memory and morsels stream to the
        device on demand."""
        from ..columnar.ingest import arrow_column_to_numpy

        names = list(t.schema.names)
        dtypes, datas, valids, dicts = [], [], [], []
        for i in range(len(names)):
            dt, data, valid, dic = arrow_column_to_numpy(t.column(i))
            dtypes.append(dt)
            datas.append(data)
            valids.append(valid)
            dicts.append(dic)
        return HostTable(names, dtypes, datas, valids, dicts, t.num_rows, morsel_rows, device)

    @staticmethod
    def from_parquet(path: str, morsel_rows: int = DEFAULT_MORSEL_ROWS, device=None) -> "HostTable":
        import pyarrow.parquet as pq

        return HostTable.from_arrow(pq.read_table(path), morsel_rows, device)

    def to(self, device) -> "HostTable":
        """The same host columns kept for another device (pinned there when
        it is the card); the table itself when it is already there."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return HostTable(self.names, self.dtypes, self.datas, self.valids, self.dicts,
                         self.nrows, self.morsel_rows, dev)

    # ---- shape -------------------------------------------------------------
    def schema(self) -> Schema:
        return Schema([Field(n, dt, True) for n, dt in zip(self.names, self.dtypes)])

    def select(self, indices: list[int]) -> "HostTable":
        """The columns ``indices``, sharing their host buffers (no copy, no
        second pinning)."""
        out = HostTable.__new__(HostTable)
        out.names = [self.names[i] for i in indices]
        out.dtypes = [self.dtypes[i] for i in indices]
        out.datas = [self.datas[i] for i in indices]
        out.valids = [self.valids[i] for i in indices]
        out.dicts = [self.dicts[i] for i in indices]
        out.nrows, out.morsel_rows, out.device = self.nrows, self.morsel_rows, self.device
        out.pin_seconds = 0.0
        out._materialized = None
        return out

    @property
    def num_morsels(self) -> int:
        return max(1, -(-self.nrows // self.morsel_rows))

    @property
    def nbytes(self) -> int:
        """Bytes of column data and validity masks in host memory."""
        return sum(d.nbytes + v.nbytes for d, v in zip(self.datas, self.valids))

    # ---- device transfer ---------------------------------------------------
    def morsel(self, i: int) -> Table:
        """Device Table of morsel i: rows [i*M, min((i+1)*M, nrows)), padded
        to the static morsel capacity (one shape for the whole scan).  The
        copies are issued on the current stream and not waited for."""
        m = self.morsel_rows
        lo = i * m
        hi = min(lo + m, self.nrows)
        if lo >= self.nrows and i != 0:
            raise InternalError(f"morsel {i} out of range")
        return self._upload(lo, hi, round_capacity(m))

    def stream_morsels(self) -> "MorselStream":
        """The morsels' device Tables, in order (``MorselStream``)."""
        return MorselStream(self)

    def materialize(self) -> Table:
        """The whole table on the device, for consumers that need it all
        (joins whose probe cannot stream, distributed shipping).  Cached."""
        if self._materialized is None:
            self._materialized = self._upload(0, self.nrows, round_capacity(self.nrows))
        return self._materialized

    def _upload(self, lo: int, hi: int, cap: int) -> Table:
        k = hi - lo
        cols = []
        for dt, d, v, dic in zip(self.dtypes, self.datas, self.valids, self.dicts):
            cols.append(Column(dt, self._copy(d, lo, hi, cap), self._copy(v, lo, hi, cap), dic))
        if tracing.enabled():
            # the host rows copied: each column's data and validity
            tracing.count("dftpu.h2d.bytes", sum(d[lo:hi].nbytes + v[lo:hi].nbytes
                                                 for d, v in zip(self.datas, self.valids)))
        return Table(self.names, cols, k, device=self.device)

    def _copy(self, host: np.ndarray, lo: int, hi: int, cap: int) -> torch.Tensor:
        """Rows [lo, hi) of a host column in a new device buffer of ``cap``
        rows; the tail is zeroed on the device."""
        k = hi - lo
        out = torch.empty((cap,) + host.shape[1:], dtype=torch_dtype(host.dtype), device=self.device)
        if k:
            out[:k].copy_(torch.from_numpy(host[lo:hi]), non_blocking=True)
        if k < cap:
            out[k:].zero_()
        return out


def _host_array(a: np.ndarray, dtype) -> np.ndarray:
    """``a`` as a contiguous, writable array of ``dtype`` (a copy only when
    it is not one already)."""
    out = np.ascontiguousarray(a, dtype=dtype)
    return out if out.flags.writeable else out.copy()


def _pinned(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` in pinned host memory, as a numpy view (which keeps
    the pinned buffer alive)."""
    out = torch.empty(a.shape, dtype=torch_dtype(a.dtype), pin_memory=True).numpy()
    out[...] = a
    return out


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _COPY_STREAMS:
        _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return _COPY_STREAMS[device]


# byte alignment of each buffer inside a morsel's flat device buffer
_ALIGN = 256


class MorselStream:
    """The morsels of a HostTable, in order, each as a device Table
    (``next``), or on the card in the loop's one static buffer
    (``next_static``).

    On the card the rows go from pinned memory into one staging buffer,
    allocated once per loop: every column's data and validity and the
    morsel's row count, in one flat byte buffer.  The copies run on a side
    stream, issued one morsel ahead: morsel i+1 is copied while the
    caller's kernels run on morsel i.  To receive a morsel, the caller's
    stream waits for its copies (an event, not a host wait) and copies the
    staging buffer, device to device and in one launch, into the morsel's
    own buffer, which only the caller's stream uses: a fresh one, or the
    static one, whose addresses stay fixed for the loop (a CUDA graph
    reads them).  The side stream writes the next morsel only after that
    copy.  The rows past the short last morsel's end are zeroed."""

    def __init__(self, host: HostTable):
        self.host = host
        self.i = 0  # the next morsel
        self.device = host.device
        if self.device.type != "cuda":
            return
        self.capacity = round_capacity(host.morsel_rows)
        # each column's data and validity: (byte offset, bytes, torch
        # dtype, shape) inside a flat buffer whose first 8 bytes hold the
        # row count
        self._arrays = [a for pair in zip(host.datas, host.valids) for a in pair]
        self._layout, off = [], _ALIGN
        for a in self._arrays:
            shape = (self.capacity,) + a.shape[1:]
            nbytes = a.dtype.itemsize * int(np.prod(shape, dtype=np.int64))
            self._layout.append((off, nbytes, torch_dtype(a.dtype), shape))
            off += -(-nbytes // _ALIGN) * _ALIGN
        self._side = _copy_stream(self.device)
        # the side stream writes it first: allocated there, so no work of
        # the caller's that is still queued holds its memory, and freed
        # only after the caller's copies out of it
        with torch.cuda.stream(self._side):
            self._staging = torch.empty(off, dtype=torch.uint8, device=self.device)
        self._staging.record_stream(torch.cuda.current_stream(self.device))
        self._staging_views = self._views(self._staging)
        self._static = self._static_table = None
        m = host.morsel_rows
        self._rows = [min(m, host.nrows - i * m) for i in range(host.num_morsels)]
        self._counts = torch.tensor(self._rows, dtype=torch.int64).pin_memory()
        self._received = None  # the caller's copy out of the staging buffer
        self._issue(0)

    def __iter__(self):
        return self

    def __next__(self) -> Table:
        if self.i >= self.host.num_morsels:
            raise StopIteration
        if self.device.type != "cuda":
            self.i += 1
            return self.host.morsel(self.i - 1)
        buf = torch.empty_like(self._staging)
        k = self._receive(buf)
        return self._table(buf, k)

    def next_static(self) -> Table:
        """The next morsel in the loop's static buffer (on the card only),
        its row count a device value: every morsel has the same buffers
        and the same capacity, whose learned sizes it keeps
        (``_cap_learned``).  Valid until the next call."""
        if self.device.type != "cuda" or self.i >= self.host.num_morsels:
            raise InternalError("no static morsel to stream")
        if self._static is None:
            self._static = torch.empty_like(self._staging)
            t = self._table(self._static, self._static[:8].view(torch.int64)[0])
            t._cap_learned = True
            self._static_table = t
        self._receive(self._static)
        return self._static_table

    def copy_static(self) -> Table:
        """The static buffer's morsel (the one ``next_static`` returned
        last) in a fresh buffer, its row count on the host."""
        buf = self._static.clone()
        return self._table(buf, self._rows[self.i - 1])

    def _issue(self, i: int) -> None:
        """Copy morsel i into the staging buffer on the side stream."""
        lo = i * self.host.morsel_rows
        k = self._rows[i]
        hi = lo + k
        with torch.cuda.stream(self._side):
            if self._received is not None:
                self._side.wait_event(self._received)
            self._staging[:8].view(torch.int64).copy_(self._counts[i:i + 1], non_blocking=True)
            for a, dst in zip(self._arrays, self._staging_views):
                if k:
                    dst[:k].copy_(torch.from_numpy(a[lo:hi]), non_blocking=True)
                if k < self.capacity:
                    dst[k:].zero_()
            self._copied = torch.cuda.Event()
            self._copied.record(self._side)
        if tracing.enabled():
            # the host rows copied: each column's data and validity
            tracing.count("dftpu.h2d.bytes", sum(a[lo:hi].nbytes for a in self._arrays))

    def _receive(self, buf: torch.Tensor) -> int:
        """Copy the next morsel from the staging buffer into ``buf`` on the
        caller's stream and issue the copies of the one after; the
        morsel's row count."""
        main = torch.cuda.current_stream(self.device)
        main.wait_event(self._copied)
        buf.copy_(self._staging)
        self._received = torch.cuda.Event()
        self._received.record(main)
        i = self.i
        self.i += 1
        if self.i < self.host.num_morsels:
            self._issue(self.i)
        return self._rows[i]

    def _views(self, buf: torch.Tensor) -> list:
        """Each column's data and validity inside a flat buffer."""
        return [buf[off:off + n].view(dt).view(shape) for off, n, dt, shape in self._layout]

    def _table(self, buf: torch.Tensor, nrows) -> Table:
        v = self._views(buf)
        h = self.host
        cols = [Column(dt, v[2 * j], v[2 * j + 1], dic) for j, (dt, dic) in enumerate(zip(h.dtypes, h.dicts))]
        return Table(h.names, cols, nrows, device=self.device)


class HostMemoryExec(MemoryExec):
    """Scan leaf over a HostTable.  As a MemoryExec it materializes the
    table for any consumer that reads ``.table``; the fused-stage rule
    (``physical/fuse.py``) intercepts it first and streams morsels
    (``physical/morsel.py``)."""

    def __init__(self, host: HostTable, schema: Schema, projection=None, table_name: str = ""):
        # not MemoryExec.__init__: the table stays unmaterialized
        ExecutionPlan.__init__(self)
        self.host = host
        self._schema = schema
        self.projection = projection
        self.table_name = table_name

    @property
    def table(self) -> Table:
        return self.host.materialize()

    def projected_host(self) -> HostTable:
        if self.projection is None:
            return self.host
        return self.host.select(self.projection)

    def _display_line(self):
        return (
            f"HostMemoryExec: {self.host.nrows} rows"
            f" ({self.host.num_morsels} morsels x {self.host.morsel_rows})"
        )


class HostTableProvider(TableProvider):
    """Catalog provider for host-resident tables (register_host_table)."""

    def __init__(self, host: HostTable):
        self.host = host

    def schema(self) -> Schema:
        return self.host.schema()

    def statistics(self):
        return Statistics(num_rows=self.host.nrows, is_exact=True)

    def scan(self, projection=None, filters=None, limit=None, table_name=""):
        return HostMemoryExec(self.host, self.host.schema(), projection, table_name)
