"""Shuffle spill files: the at-rest columnar interchange format.

Port of ``datafusion_tpu/distributed/shuffle_io.py``.  Equivalent of
Ballista's Arrow-IPC shuffle files
(ballista/rust/core/src/execution_plans/shuffle_writer.rs:130-260,
core/src/utils.rs:69 write_stream_to_disk): a completed stage's output
partitions are durable files that never re-run, fetched by the next
stage's readers.

Format (``.dfs``, "DataFusion-TPU Shuffle" v1), the JAX package's byte for
byte, so that a file written by either engine reads in the other:
    magic  b"DFS1"
    u32 LE header_len
    header: UTF-8 JSON {
        "nrows": int,
        "columns": [{"name", "kind", "precision", "scale", "tz",
                      "np_dtype", "dict": [values]|None}, ...],
    }
    per column, in order: data bytes (nrows * itemsize, C order)
                          valid bytes (nrows * 1, uint8)

Device columns cross to the host in one copy per table: the body is laid
out on the device (every column's live data and validity bytes, one
``torch.cat``) and copied once, so a write waits for the device once, not
once per column.  A read copies the file's body to the device once and
cuts the columns there.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.dictionary import StringDict
from ..columnar.table import Table, host_numpy, round_capacity
from ..device import resolve_device, torch_dtype
from ..errors import InternalError
from ..types.dtypes import DataType

MAGIC = b"DFS1"


def _dtype_to_meta(dt: DataType) -> dict:
    return {
        "kind": dt.kind,
        "precision": dt.precision,
        "scale": dt.scale,
        "tz": dt.tz,
    }


def _dtype_from_meta(m: dict) -> DataType:
    return DataType(m["kind"], m.get("precision", 0), m.get("scale", 0), m.get("tz"))


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def host_arrays(tensors: list) -> list:
    """The tensors as numpy arrays, copied to the host in one go: their
    bytes are packed on the device by one ``torch.cat`` and copied once
    (one wait for the device, counted in ``HOST_SYNCS``)."""
    if not tensors:
        return []
    flat = [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
    raw = host_numpy(torch.cat(flat)) if len(flat) > 1 else host_numpy(flat[0])
    out, off = [], 0
    for t, f in zip(tensors, flat):
        nb = f.numel()
        out.append(raw[off: off + nb].view(_np_dtype(t)).reshape(tuple(t.shape)))
        off += nb
    return out


def column_meta(name: str, c: Column, np_dtype: np.dtype) -> str:
    """One column's entry of the header, as JSON text: encoded once and
    reused by every partition file a writer cuts from one table."""
    meta = _dtype_to_meta(c.dtype)
    meta["name"] = name
    meta["np_dtype"] = np_dtype.str
    meta["dict"] = (
        [str(v) for v in c.dictionary.values] if c.dictionary is not None else None
    )
    return json.dumps(meta)


def write_file(path: str, nrows: int, cols_meta: list, bufs: list) -> dict:
    """Write one ``.dfs`` file from host buffers (each column's data bytes,
    then its valid bytes as uint8) and the columns' header entries
    (``column_meta``); returns PartitionStats (rows/batches/bytes, as
    shuffle_writer.rs:260-300).  The header is the text ``json.dumps``
    gives for {"nrows": ..., "columns": [...]}."""
    header = f'{{"nrows": {int(nrows)}, "columns": [{", ".join(cols_meta)}]}}'.encode("utf-8")
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for b in bufs:
            f.write(memoryview(np.ascontiguousarray(b)).cast("B"))
    os.replace(tmp, path)  # atomic: readers never see partial files
    nbytes = sum(np.asarray(b).nbytes for b in bufs)
    return {"rows": int(nrows), "batches": 1, "bytes": int(nbytes), "path": path}


def write_table(path: str, t: Table) -> dict:
    """Write the live rows of ``t``; returns PartitionStats."""
    n = t.nrows
    tensors = []
    for c in t.columns:
        tensors += [c.data[:n], c.valid[:n]]
    arrays = host_arrays(tensors)
    cols_meta = [
        column_meta(name, c, arrays[2 * j].dtype)
        for j, (name, c) in enumerate(zip(t.names, t.columns))
    ]
    bufs = [a.view(np.uint8) if a.dtype == np.bool_ else a for a in arrays]
    return write_file(path, n, cols_meta, bufs)


def read_header(path: str) -> tuple[dict, bytearray, int]:
    """(header, the file's bytes, offset of the body)."""
    raw = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(raw)
    if raw[:4] != MAGIC:
        raise InternalError(f"{path}: bad shuffle file magic")
    (hlen,) = struct.unpack("<I", raw[4:8])
    header = json.loads(bytes(raw[8: 8 + hlen]).decode("utf-8"))
    return header, raw, 8 + hlen


def read_table(path: str, device=None) -> Table:
    """A ``.dfs`` file as a Table on ``device`` (None: the card): one
    host-to-device copy of the body, the columns cut from it there."""
    dev = resolve_device(device)
    header, raw, off = read_header(path)
    n = header["nrows"]
    cap = round_capacity(n)
    body = torch.frombuffer(raw, dtype=torch.uint8, offset=off) if len(raw) > off else None
    if body is not None:
        body = body.to(dev)
    pos = 0
    names, cols = [], []
    for m in header["columns"]:
        dt = _dtype_from_meta(m)
        np_dt = np.dtype(m["np_dtype"])
        sz = n * np_dt.itemsize
        data = torch.zeros(cap, dtype=torch_dtype(np_dt), device=dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        if n:
            data[:n].view(torch.uint8).copy_(body[pos: pos + sz])
            valid[:n].view(torch.uint8).copy_(body[pos + sz: pos + sz + n] != 0)
        pos += sz + n
        dic = (
            StringDict(np.array(m["dict"], dtype=object))
            if m["dict"] is not None
            else None
        )
        names.append(m["name"])
        cols.append(Column(dt, data, valid, dic))
    return Table(names, cols, n, device=dev)


def _remapped_codes(all_vals: np.ndarray, dic, codes: torch.Tensor) -> torch.Tensor:
    """A part's string codes in the merged dictionary ``all_vals``: the
    part's remap table (a ``searchsorted`` on the host, one entry per
    dictionary value) gathered on the device."""
    if dic is None or len(dic) == 0:
        return codes
    rm = np.searchsorted(all_vals, dic.values.astype(str)).astype(np.int32)
    lut = torch.from_numpy(rm).to(codes.device)
    return lut[codes.long().clamp(0, len(rm) - 1)]


def _shared_dictionary(dics: list):
    """The one dictionary every non-empty part holds, when its values are
    strictly sorted (then it is their ``np.unique`` union), else None."""
    live = [d for d in dics if d is not None and len(d)]
    if not live:
        return None
    first = live[0].values
    if not all(d.values is first or np.array_equal(d.values, first) for d in live[1:]):
        return None
    return live[0] if bool(np.all(first[1:] > first[:-1])) else None


def concat_read(paths: list[str], schema, device=None) -> Table:
    """Read several partition files and concatenate them on ``device``
    (ShuffleReaderExec's join_all of fetched streams,
    shuffle_reader.rs:97-157).  String columns get one union dictionary
    (``np.unique`` of every part's values) and each part's codes are
    remapped into it, as the JAX package merges them."""
    dev = resolve_device(device)
    tables = [read_table(p, dev) for p in paths if os.path.exists(p)]
    tables = [t for t in tables if t.nrows > 0]
    if not tables:
        return Table.empty(schema, device=dev)
    if len(tables) == 1:
        return tables[0]
    total = sum(t.nrows for t in tables)
    cap = round_capacity(total)
    names = tables[0].names
    cols = []
    for j in range(len(names)):
        parts_d = [t.columns[j].data[: t.nrows] for t in tables]
        parts_v = [t.columns[j].valid[: t.nrows] for t in tables]
        dt = tables[0].columns[j].dtype
        dics = [t.columns[j].dictionary for t in tables]
        dic = None
        shared = _shared_dictionary(dics) if dt.is_string else None
        if shared is not None:
            # every part carries one sorted dictionary (the columns of one
            # writer's table): the union is that dictionary, no code moves
            dic = StringDict(shared.values)
        elif dt.is_string:
            # N-way merge: one union dictionary, per-part code remaps
            all_vals = np.unique(
                np.concatenate(
                    [d.values.astype(str) for d in dics if d is not None and len(d)]
                    or [np.array([], dtype=str)]
                )
            )
            dic = StringDict(all_vals.astype(object))
            parts_d = [_remapped_codes(all_vals, d0, d) for d0, d in zip(dics, parts_d)]
        pad = cap - total
        data = torch.cat(parts_d + [parts_d[0].new_zeros((pad,) + tuple(parts_d[0].shape[1:]))])
        valid = torch.cat(parts_v + [parts_v[0].new_zeros(pad)])
        cols.append(Column(dt, data, valid, dic))
    return Table(list(names), cols, total, device=dev)
