"""Shuffle spill files and the shuffle writer of the torch port against
the JAX package's, on the CPU.

The data is made from a numpy seed: a table of every storage dtype the
engines have (signed and unsigned integers, float32 and float64 with -0.0,
NaN and infinities, bool, decimal, date32, timestamp, dictionary strings),
with NULLs.  Both engines hold identical buffers (the JAX package's Table,
moved into the port by ``torch_parity.port_table``), data under NULL rows
included, so the files are compared whole, byte for byte, with nothing
masked.

  * ``write_table`` writes the same bytes in both engines, and each engine
    reads the other's file to the same columns, bit for bit.
  * ``concat_read`` of three files with different dictionaries gives the
    same codes and the same merged dictionary in both engines.
  * ``ShuffleWriterExec`` writes the same output partition files, byte for
    byte, in both engines for int, string, float and composite keys with
    NULLs, at m = 3 and m = 16; the keys include 64-bit hashes with the top
    bit set, where a signed remainder would pick another partition.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import os

import numpy as np
import pytest
import torch

from datafusion_tpu.columnar.column import Column as JColumn
from datafusion_tpu.columnar.dictionary import StringDict as JStringDict
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.distributed import shuffle_io as jsio
from datafusion_tpu.distributed.exchange import ShuffleWriterExec as JWriter
from datafusion_tpu.exprs.physical import PhysCol as JCol
from datafusion_tpu.ops.basic import MemoryExec as JMemory
from datafusion_tpu.types.dtypes import DataType, decimal

from datafusion_tpu_torch.distributed import shuffle_io as psio
from datafusion_tpu_torch.distributed.exchange import ShuffleWriterExec as PWriter
from datafusion_tpu_torch.exprs.physical import PhysCol as PCol
from datafusion_tpu_torch.ops import kernels as K
from datafusion_tpu_torch.ops.basic import MemoryExec as PMemory
from datafusion_tpu_torch.parallel.shuffle import hash_dest

from torch_parity import port_table

N = 700
SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf])
KINDS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
         "float32", "float64", "bool", "decimal", "date32", "timestamp", "string"]


def _dtype(kind: str) -> DataType:
    return decimal(15, 2) if kind == "decimal" else DataType(kind)


def _values(kind: str, rng, n: int, words) -> np.ndarray:
    if kind.startswith(("int", "uint")):
        info = np.iinfo(np.dtype(kind))
        return rng.integers(info.min, info.max, n, dtype=np.dtype(kind), endpoint=True)
    if kind.startswith("float"):
        v = rng.normal(0, 1e6, n)
        special = rng.random(n) < 0.2
        v[special] = rng.choice(SPECIALS, int(special.sum()))
        v[:5] = SPECIALS[:n]
        return v.astype(kind)
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind == "decimal":
        return rng.integers(-10**15, 10**15, n)
    if kind == "date32":
        return rng.integers(-20000, 30000, n).astype(np.int32)
    if kind == "timestamp":
        return rng.integers(-2**62, 2**62, n)
    return rng.integers(0, len(words), n).astype(np.int32)


def jax_table(seed: int, kinds=KINDS, words=("apple", "kiwi", "pear", "fig", "lime"), n=N) -> JTable:
    """A JAX Table of ``kinds`` from a numpy seed; NULLs at random rows
    (their data left random too), strings over ``words``."""
    rng = np.random.default_rng(seed)
    cap = 4096
    cols = []
    for kind in kinds:
        dt = _dtype(kind)
        data = _values(kind, rng, n, words)
        valid = rng.random(n) > 0.15
        dic = JStringDict(np.array(sorted(words), dtype=object)) if kind == "string" else None
        cols.append(JColumn.from_numpy(dt, data, valid, dic, capacity=cap))
    return JTable([f"c_{k}" for k in kinds], cols, n)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def assert_same_columns(got, want) -> None:
    """Two tables (of either engine) hold the same live rows bit for bit:
    data, validity and dictionaries."""
    assert list(got.names) == list(want.names)
    assert got.nrows == want.nrows
    n = want.nrows
    for g, w in zip(got.columns, want.columns):
        assert g.dtype.kind == w.dtype.kind and g.dtype.scale == w.dtype.scale
        gd, wd = np.asarray(g.data[:n]), np.asarray(w.data[:n])
        assert gd.dtype == wd.dtype
        assert np.array_equal(_bits(gd), _bits(wd))
        assert np.array_equal(np.asarray(g.valid[:n]), np.asarray(w.valid[:n]))
        if w.dictionary is None:
            assert g.dictionary is None
        else:
            assert list(g.dictionary.values) == list(w.dictionary.values)


def test_write_table_bytes_equal_and_files_cross_read(tmp_path):
    jt = jax_table(1)
    pt = port_table(jt)
    jpath, ppath = str(tmp_path / "j" / "t.dfs"), str(tmp_path / "p" / "t.dfs")
    js = jsio.write_table(jpath, jt)
    ps = psio.write_table(ppath, pt)
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    assert {k: v for k, v in ps.items() if k != "path"} == {k: v for k, v in js.items() if k != "path"}
    # each engine reads the other's file
    assert_same_columns(psio.read_table(jpath, "cpu"), jt)
    assert_same_columns(jsio.read_table(ppath), jt)
    assert psio.read_table(jpath, "cpu").capacity == jsio.read_table(ppath).capacity


def test_empty_table_file(tmp_path):
    jt = jax_table(2, n=0)
    path = str(tmp_path / "e.dfs")
    psio.write_table(path, port_table(jt))
    jsio.write_table(str(tmp_path / "j.dfs"), jt)
    assert open(path, "rb").read() == open(str(tmp_path / "j.dfs"), "rb").read()
    got = psio.read_table(path, "cpu")
    assert got.nrows == 0 and got.names == list(jt.names)


CONCAT_WORDS = {
    "different": [("apple", "kiwi", "pear"), ("banana", "kiwi", "zucchini", "apple"), ("fig",)],
    # one writer's partitions: every file carries the same dictionary
    "shared": [("apple", "banana", "fig", "kiwi", "pear", "zucchini")] * 3,
}


@pytest.mark.parametrize("words", list(CONCAT_WORDS))
def test_concat_read_merges_dictionaries_as_the_jax_package(tmp_path, words):
    w = CONCAT_WORDS[words]
    parts = [jax_table(3, words=w[0]), jax_table(4, words=w[1]), jax_table(5, words=w[2], n=300)]
    paths = []
    for i, t in enumerate(parts):
        paths.append(str(tmp_path / f"in{i}.dfs"))
        jsio.write_table(paths[-1], t)
    paths.append(str(tmp_path / "missing.dfs"))  # skipped by both
    schema = parts[0].schema()
    want = jsio.concat_read(paths, schema)
    got = psio.concat_read(paths, port_table(parts[0]).schema(), "cpu")
    assert got.nrows == want.nrows == sum(t.nrows for t in parts)
    assert got.capacity == want.capacity
    assert_same_columns(got, want)
    s = got.names.index("c_string")
    assert list(got.columns[s].dictionary.values) == ["apple", "banana", "fig", "kiwi", "pear", "zucchini"]


def test_string_value_hashes_equal_the_jax_package():
    from datafusion_tpu.distributed.exchange import _fnv1a64 as jfnv
    from datafusion_tpu_torch.distributed.exchange import fnv1a64_all

    rng = np.random.default_rng(8)
    alphabet = list("abcXYZ09 -_|") + ["é", "ß", "中", "😀"]
    words = ["", "a", "x" * 300] + [
        "".join(rng.choice(alphabet, int(rng.integers(0, 40)))) for _ in range(500)
    ]
    assert fnv1a64_all(words).tolist() == [jfnv(w) for w in words]
    assert fnv1a64_all([]).shape == (0,) and fnv1a64_all([""]).tolist() == [jfnv("")]


KEY_SETS = {
    "int": ["c_int64"],
    "string": ["c_string"],
    "float": ["c_float64"],
    "composite": ["c_int32", "c_string", "c_float32", "c_uint64"],
}


@pytest.mark.parametrize("m", [3, 16])
@pytest.mark.parametrize("keys", list(KEY_SETS))
def test_shuffle_writer_partitions_equal_the_jax_package(tmp_path, keys, m):
    check_shuffle_writer(tmp_path, keys, m)


def test_shuffle_writer_without_the_native_library(tmp_path, monkeypatch):
    """Where the native library is not built, the bucket order comes from
    a stable argsort: the same files."""
    from datafusion_tpu_torch import native_lib

    monkeypatch.setattr(native_lib, "partition_order", lambda hashes, m: None)
    check_shuffle_writer(tmp_path, "composite", 3)


def check_shuffle_writer(tmp_path, keys, m):
    jt = jax_table(6, words=tuple(f"w{i}" for i in range(40)))
    pt = port_table(jt)
    names = KEY_SETS[keys]
    idx = [jt.names.index(k) for k in names]
    jexprs = [JCol(jt.names[i], i, jt.columns[i].dtype) for i in idx]
    pexprs = [PCol(pt.names[i], i, pt.columns[i].dtype) for i in idx]
    jw = JWriter("job", 1, JMemory(jt, jt.schema()), jexprs, m, str(tmp_path / "j"), 2)
    pw = PWriter("job", 1, PMemory(pt, pt.schema()), pexprs, m, str(tmp_path / "p"), 2)
    js, ps = jw.execute_shuffle_write(), pw.execute_shuffle_write()
    assert [s["rows"] for s in ps] == [s["rows"] for s in js]
    assert sum(s["rows"] for s in ps) == N
    assert sum(1 for s in ps if s["rows"]) > 1
    for p in range(m):
        jf = JWriter.file_path(str(tmp_path / "j"), "job", 1, 2, p)
        pf = PWriter.file_path(str(tmp_path / "p"), "job", 1, 2, p)
        assert os.path.basename(jf) == os.path.basename(pf) == f"in2_out{p}.dfs"
        assert open(pf, "rb").read() == open(jf, "rb").read(), f"partition {p} differs"
    if keys in ("int", "float"):
        # the keys reach the top bit of the hash, where the signed
        # remainder of the int64 bits would send rows elsewhere
        c = pt.columns[idx[0]]
        h = K.hash_columns([K.hashable_key(c.data[:N], c.dtype)], [c.valid[:N]])
        assert bool((h < 0).any())
        if m == 3:
            assert bool((torch.remainder(h, m) != hash_dest(h, m)).any())
