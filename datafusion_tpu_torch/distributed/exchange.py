"""Exchange operators for staged distributed execution.

Port of ``datafusion_tpu/distributed/exchange.py``.  Equivalents of
Ballista's execution_plans (ballista/rust/core/src/execution_plans/):
  ShuffleWriterExec    shuffle_writer.rs:63   run a stage for one input
                       partition; hash-partition the output into n spill
                       files (or one file when coalescing)
  ShuffleReaderExec    shuffle_reader.rs:46   fetch + concat assigned files
  UnresolvedShuffleExec unresolved_shuffle.rs:39  placeholder swapped for a
                       reader once stage locations are known
  DistScanExec         (scan leaf)            one partition slice of a
                       registered table, by named-table reference so task
                       plans stay compact on the wire

These operators move host-level data between stages (spill files on a
shared filesystem); the exchange inside one executor's mesh is the
``parallel`` package's.  Each stage's operator subtree runs unfused on the
executor's device.  A stage's output crosses to the host in one copy
(``shuffle_io.host_arrays``), its rows are bucketed there and written
per output partition; readers copy each file to the device once.

``TIMES`` adds up, for this process, the seconds of each part of a task
(the stage subtree's run, the device-to-host copy with the file writes,
the file reads with the host-to-device copies) and the bytes written and
read.  Executor threads that share a card share its stream, so one
thread's times include waiting for the other's queued work.
"""

from __future__ import annotations

import os
import threading
import time
from collections import Counter

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.table import Table, round_capacity
from ..device import resolve_device
from ..errors import InternalError
from ..ops import kernels as K
from ..ops.base import ExecutionPlan
from ..parallel.shuffle import hash_dest
from ..types import Schema
from . import shuffle_io

_TIMES_LOCK = threading.Lock()
# seconds and bytes of the exchanges in this process (see the docstring)
TIMES: Counter = Counter()


def add_times(**kw) -> None:
    with _TIMES_LOCK:
        TIMES.update(kw)


def reset_times() -> None:
    with _TIMES_LOCK:
        TIMES.clear()


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# ---------------------------------------------------------------------------


def fnv1a64_all(values) -> np.ndarray:
    """The deterministic cross-process string hash (FNV-1a, 64-bit, over
    the UTF-8 bytes; the JAX package's ``_fnv1a64``) of every string, as
    int64, with numpy: one step over all strings per byte position."""
    enc = [str(v).encode("utf-8") for v in values]
    lens = np.fromiter(map(len, enc), np.int64, len(enc))
    h = np.full(len(enc), 0xCBF29CE484222325, np.uint64)
    if not len(enc) or not lens.max():
        return h.view(np.int64)
    flat = np.frombuffer(b"".join(enc), np.uint8)
    buf = np.zeros((len(enc), int(lens.max())), np.uint8)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    buf[np.repeat(np.arange(len(enc)), lens), np.arange(len(flat)) - starts] = flat
    prime = np.uint64(0x100000001B3)
    for j in range(buf.shape[1]):
        live = lens > j
        h[live] = (h[live] ^ buf[live, j]) * prime  # wraps modulo 2^64
    return h.view(np.int64)


def _string_value_hashes(dic, device: torch.device) -> torch.Tensor:
    """int64 value-hash table over a StringDict's codes, on ``device``:
    made once per dictionary and copied once per device (cached on the
    dictionary)."""
    cache = getattr(dic, "_value_hash_lut", None)
    if cache is None:
        cache = {"host": fnv1a64_all(dic.values)}
        dic._value_hash_lut = cache
    key = str(device)
    lut = cache.get(key)
    if lut is None:
        lut = cache[key] = torch.from_numpy(cache["host"]).to(device)
    return lut


def slice_table(t: Table, lo: int, hi: int) -> Table:
    """Row-range view [lo, hi) as a compacted Table, cut on the device
    at ``round_capacity(hi - lo)``."""
    n = max(hi - lo, 0)
    cap = round_capacity(n)
    cols = []
    for c in t.columns:
        d = c.data[lo: lo + n]
        v = c.valid[lo: lo + n]
        cols.append(Column(
            c.dtype,
            torch.cat([d, d.new_zeros((cap - n,) + tuple(d.shape[1:]))]),
            torch.cat([v, v.new_zeros(cap - n)]),
            c.dictionary,
        ))
    return Table(list(t.names), cols, n, device=t.device)


class TableStore:
    """Named-table registry shared by scheduler and executors.

    Standalone mode: one in-process object (Ballista's standalone sled +
    in-process executor, client/src/context.rs:83-115).  Multi-process
    mode: `spill_dir` backs every table as a .dfs file that executors load
    lazily onto ``device`` (None: the card).
    """

    def __init__(self, spill_dir: str | None = None, device=None):
        self._tables: dict[str, Table] = {}
        self.spill_dir = spill_dir
        self.device = device

    def put(self, name: str, t: Table):
        self._tables[name] = t
        if self.spill_dir is not None:
            shuffle_io.write_table(os.path.join(self.spill_dir, f"{name}.dfs"), t)

    def get(self, name: str) -> Table:
        t = self._tables.get(name)
        if t is None and self.spill_dir is not None:
            path = os.path.join(self.spill_dir, f"{name}.dfs")
            if os.path.exists(path):
                t = shuffle_io.read_table(path, self.device)
                self._tables[name] = t
        if t is None:
            raise InternalError(f"table '{name}' not in executor table store")
        return t

    def names(self) -> list[str]:
        return sorted(self._tables)


# ---------------------------------------------------------------------------


class DistScanExec(ExecutionPlan):
    """Partition `partition`/`num_partitions` of a registered table."""

    def __init__(
        self,
        table_name: str,
        schema: Schema,
        projection: list[int] | None,
        num_partitions: int,
        partition: int | None = None,
        store: TableStore | None = None,
    ):
        super().__init__()
        self.table_name = table_name
        self._schema = schema
        self.projection = projection
        self.num_partitions = num_partitions
        self.partition = partition
        self.store = store

    def schema(self) -> Schema:
        if self.projection is None:
            return self._schema
        return Schema([self._schema.fields[i] for i in self.projection])

    def with_new_children(self, c):
        return self

    def output_partition_count(self) -> int:
        return self.num_partitions

    def _execute(self) -> Table:
        if self.store is None or self.partition is None:
            raise InternalError("DistScanExec not bound to a store/partition")
        t = self.store.get(self.table_name)
        if self.projection is not None:
            t = t.select([t.names[i] for i in self.projection])
        per = -(-max(t.nrows, 1) // self.num_partitions)
        lo = min(self.partition * per, t.nrows)
        hi = min(lo + per, t.nrows)
        out = slice_table(t, lo, hi)
        # physical column names must match the planned (qualified) names
        return Table(self.schema().names(), out.columns, out.nrows, device=out.device)

    def _display_line(self):
        p = "*" if self.partition is None else self.partition
        return f"DistScanExec: {self.table_name}[{p}/{self.num_partitions}]"


def _reader_seconds(plan: ExecutionPlan) -> float:
    """Seconds the plan's shuffle readers spent reading files and copying
    them to the device."""
    s = plan.metrics.counter("read_ns").value / 1e9 if isinstance(plan, ShuffleReaderExec) else 0.0
    return s + sum(_reader_seconds(c) for c in plan.children())


class ShuffleWriterExec(ExecutionPlan):
    """Execute the inner plan for one input partition and write its output
    into `num_output_partitions` spill files (hash of `partition_exprs`),
    or a single file when `partition_exprs` is None (coalesce)."""

    def __init__(
        self,
        job_id: str,
        stage_id: int,
        plan: ExecutionPlan,
        partition_exprs: list | None,  # list[PhysicalExpr] or None
        num_output_partitions: int,
        work_dir: str = "",
        input_partition: int = 0,
    ):
        super().__init__()
        self.job_id = job_id
        self.stage_id = stage_id
        self.plan = plan
        self.partition_exprs = partition_exprs
        self.num_output_partitions = num_output_partitions
        self.work_dir = work_dir
        self.input_partition = input_partition

    def schema(self) -> Schema:
        return self.plan.schema()

    def children(self):
        return [self.plan]

    def with_new_children(self, c):
        return ShuffleWriterExec(
            self.job_id,
            self.stage_id,
            c[0],
            self.partition_exprs,
            self.num_output_partitions,
            self.work_dir,
            self.input_partition,
        )

    # -- file layout -------------------------------------------------------
    @staticmethod
    def file_path(work_dir: str, job_id: str, stage_id: int, in_part: int, out_part: int) -> str:
        return os.path.join(
            work_dir, job_id, f"stage{stage_id}", f"in{in_part}_out{out_part}.dfs"
        )

    def _execute(self) -> Table:
        raise InternalError("ShuffleWriterExec runs via execute_shuffle_write()")

    def execute_shuffle_write(self, mesh=None) -> list[dict]:
        """Run the stage; returns per-output-partition stats + locations
        (execute_shuffle_write, shuffle_writer.rs:130).

        With ``mesh``, the stage subtree executes SPMD over the executor's
        mesh (``parallel.executor.SpmdExecutor``) instead of on one device:
        spill files across executors, the mesh's exchanges inside one."""
        t0 = time.perf_counter()
        if mesh is not None:
            from ..parallel.executor import SpmdExecutor

            t = SpmdExecutor(mesh).execute_plan(self.plan)
        else:
            t = self.plan.execute()
        n = t.nrows
        _wait(t.device)
        t1 = time.perf_counter()
        read_s = _reader_seconds(self.plan)
        m = self.num_output_partitions
        stats = []
        if self.partition_exprs is None:
            if m != 1:
                raise InternalError("coalesce shuffle must have 1 output partition")
            path = self.file_path(
                self.work_dir, self.job_id, self.stage_id, self.input_partition, 0
            )
            s = shuffle_io.write_table(path, t)
            s["output_partition"] = 0
            stats.append(s)
        else:
            stats = self._hash_write(t, n, m)
        add_times(exec_s=t1 - t0 - read_s, read_s=read_s,
                  write_s=time.perf_counter() - t1,
                  write_bytes=sum(os.path.getsize(s["path"]) for s in stats))
        self.metrics.counter("write_rows").add(int(n))
        return stats

    def _hash_write(self, t: Table, n: int, m: int) -> list[dict]:
        # hash-partition rows by key exprs (create_hashes % n -> take,
        # shuffle_writer.rs:184-260); the device shuffle's hash, and the
        # unsigned remainder of its 64 bits (parallel/shuffle.py::
        # hash_dest).  String keys hash by VALUE (FNV-1a over the
        # dictionary, then a code lookup): each partition has its own
        # dictionary, so hashing the codes would break co-partitioning
        # across writers.
        keys = [e.evaluate(t) for e in self.partition_exprs]
        if n == 0:
            buckets = torch.zeros(0, dtype=torch.int64, device=t.device)
        else:
            kdatas = []
            for c in keys:
                if c.dtype.is_string and c.dictionary is not None:
                    lut = _string_value_hashes(c.dictionary, t.device)
                    if len(lut):
                        kdatas.append(lut[c.data[:n].long().clamp(0, len(lut) - 1)])
                    else:
                        kdatas.append(torch.zeros(n, dtype=torch.int64, device=t.device))
                else:
                    kdatas.append(K.hashable_key(c.data[:n], c.dtype))
            kvalids = [c.valid[:n] for c in keys]
            buckets = hash_dest(K.hash_columns(kdatas, kvalids), m)

        # every column and the buckets cross to the host in one copy
        tensors = [buckets]
        for c in t.columns:
            tensors += [c.data[:n], c.valid[:n]]
        host = shuffle_io.host_arrays(tensors)
        hb = host[0]
        # bucket permutation: native counting sort when built, else argsort
        from .. import native_lib

        native = native_lib.partition_order(hb.astype(np.uint64), m)
        if native is not None:
            order, starts_n = native
            starts, ends = starts_n[:m], starts_n[1:]
        else:
            order = np.argsort(hb, kind="stable")
            sorted_buckets = hb[order]
            starts = np.searchsorted(sorted_buckets, np.arange(m))
            ends = np.searchsorted(sorted_buckets, np.arange(m), side="right")
        metas = [
            shuffle_io.column_meta(name, c, host[1 + 2 * j].dtype)
            for j, (name, c) in enumerate(zip(t.names, t.columns))
        ]
        stats = []
        for p in range(m):
            idx = order[starts[p]: ends[p]]
            bufs = []
            for j in range(len(t.columns)):
                bufs += [host[1 + 2 * j][idx], host[2 + 2 * j][idx].view(np.uint8)]
            path = self.file_path(
                self.work_dir, self.job_id, self.stage_id, self.input_partition, p
            )
            s = shuffle_io.write_file(path, len(idx), metas, bufs)
            s["output_partition"] = p
            stats.append(s)
        return stats

    def _display_line(self):
        how = (
            f"hash({len(self.partition_exprs)} keys)x{self.num_output_partitions}"
            if self.partition_exprs is not None
            else "coalesce"
        )
        return f"ShuffleWriterExec[stage {self.stage_id}]: {how}"


class UnresolvedShuffleExec(ExecutionPlan):
    """Placeholder for a not-yet-located upstream stage output
    (unresolved_shuffle.rs:39)."""

    def __init__(self, stage_id: int, schema: Schema, num_partitions: int):
        super().__init__()
        self.stage_id = stage_id
        self._schema = schema
        self.num_partitions = num_partitions

    def schema(self):
        return self._schema

    def with_new_children(self, c):
        return self

    def output_partition_count(self) -> int:
        return self.num_partitions

    def _execute(self):
        raise InternalError(
            f"UnresolvedShuffleExec(stage {self.stage_id}) must be resolved "
            "to a ShuffleReaderExec before execution"
        )

    def _display_line(self):
        return f"UnresolvedShuffleExec: stage {self.stage_id} x{self.num_partitions}"


class ShuffleReaderExec(ExecutionPlan):
    """Read one output partition of a completed upstream stage: concat the
    files written by every input partition (shuffle_reader.rs:97-157) on
    ``device`` (None: the card)."""

    def __init__(self, paths: list[str], schema: Schema, device=None):
        super().__init__()
        self.paths = paths
        self._schema = schema
        self.device = device

    def schema(self):
        return self._schema

    def with_new_children(self, c):
        return self

    def _execute(self) -> Table:
        t0 = time.perf_counter_ns()
        t = shuffle_io.concat_read(self.paths, self._schema, resolve_device(self.device))
        self.metrics.counter("read_ns").add(time.perf_counter_ns() - t0)
        add_times(read_bytes=sum(os.path.getsize(p) for p in self.paths if os.path.exists(p)))
        # align column names with the planned schema (qualified names)
        self.metrics.counter("fetch_rows").add(t.nrows)
        return Table(self._schema.names(), t.columns, t.nrows, device=t.device)

    def _display_line(self):
        return f"ShuffleReaderExec: {len(self.paths)} files"
