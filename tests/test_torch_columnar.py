"""Columnar layer of the torch port (datafusion_tpu_torch/columnar): tables
carried over from the JAX package with ``table_from_host`` and tables built
by ``Table.from_pydict`` must match the JAX package's Tables in capacity,
storage buffers, vrange and decoded rows."""

import numpy as np
import pytest
import torch

from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.types.dtypes import DATE32, FLOAT64, INT64, STRING, decimal
from datafusion_tpu_torch.columnar.convert import dtype_from_kind, table_from_host
from datafusion_tpu_torch.columnar.table import Table, round_capacity
from datafusion_tpu_torch.device import resolve_device
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.types import Schema, dtypes as P

from torch_parity import jax_table_to_host, kind_of, port_table


def _pydict(n, seed=0):
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.15
    dates = np.datetime64("1992-01-01", "D") + rng.integers(0, 2500, n).astype("timedelta64[D]")
    return {
        "price": [None if z else float(v) / 100 for z, v in zip(null, rng.integers(0, 10**7, n))],
        "shipdate": np.where(null[::-1], np.datetime64("NaT"), dates),
        "flag": [None if z else s for z, s in zip(np.roll(null, 3), rng.choice(["A", "N", "R"], n))],
        "qty": [None if z else int(v) for z, v in zip(np.roll(null, 5), rng.integers(-(10**12), 10**12, n))],
        "disc": [None if z else float(v) for z, v in zip(np.roll(null, 7), rng.random(n))],
    }


_DTYPES = {"price": decimal(15, 2), "shipdate": DATE32, "flag": STRING, "qty": INT64, "disc": FLOAT64}
# the same types as the torch engine's DataType objects
_PDTYPES = {k: dtype_from_kind(kind_of(v)) for k, v in _DTYPES.items()}


def _assert_same(p: Table, j: JTable):
    assert p.names == j.names
    assert p.capacity == j.capacity
    assert p.nrows == j.nrows
    n = j.nrows
    for pc, jc in zip(p.columns, j.columns):
        assert repr(pc.dtype) == repr(jc.dtype)
        assert pc.vrange == jc.vrange
        np.testing.assert_array_equal(pc.data[:n].numpy(), np.asarray(jc.data)[:n])
        np.testing.assert_array_equal(pc.valid[:n].numpy(), np.asarray(jc.valid)[:n])
        if jc.dictionary is not None:
            assert list(pc.dictionary.values) == list(jc.dictionary.values)
    assert p.to_pydict() == j.to_pydict()


@pytest.mark.parametrize("n", [0, 10, 4096, 5000])
def test_table_from_host_matches_jax_table(n):
    j = JTable.from_pydict(_pydict(n, seed=n), dtypes=_DTYPES)
    _assert_same(port_table(j), j)


@pytest.mark.parametrize("n", [10, 5000])
def test_from_pydict_matches_jax(n):
    data = _pydict(n, seed=n + 1)
    _assert_same(
        Table.from_pydict(data, dtypes=_PDTYPES, device="cpu"),
        JTable.from_pydict(data, dtypes=_DTYPES),
    )


def test_from_pydict_inferred_types_match_jax():
    data = {
        "i": np.arange(7, dtype=np.int64) - 3,
        "f": np.array([0.5, np.nan, 2.0, 3.0, np.nan, -1.0, 7.25]),
        "b": np.array([True, False, True, True, False, False, True]),
        "s": ["x", None, "y", "x", "z", None, "a"],
    }
    _assert_same(Table.from_pydict(data, device="cpu"), JTable.from_pydict(data))


def test_nrows_only_arrays_pad_to_round_capacity():
    j = JTable.from_pydict(_pydict(300), dtypes=_DTYPES)
    names, kinds, datas, valids, dicts, n = jax_table_to_host(j)
    p = table_from_host(names, kinds, [d[:n] for d in datas], [v[:n] for v in valids], dicts, n, "cpu")
    assert p.capacity == round_capacity(n) == j.capacity
    assert p.to_pydict() == j.to_pydict()


def test_dtype_from_kind():
    assert dtype_from_kind("decimal(15,2)") == P.decimal(15, 2)
    assert dtype_from_kind("DECIMAL(12, 4)") == P.decimal(12, 4)
    assert dtype_from_kind("date32") == P.DATE32
    assert dtype_from_kind("string") == P.STRING
    with pytest.raises(Exception):
        dtype_from_kind("varchar(3)")


def test_table_manipulation():
    t = Table.from_pydict({"a": list(range(5000)), "s": ["x"] * 5000}, device="cpu")
    assert t.capacity == 8192
    assert t.select(["s"]).names == ["s"]
    assert t.to("cpu") is t
    lazy = Table(t.names, t.columns, torch.tensor(3))
    small = lazy.shrink_to_fit()
    assert small.capacity == 4096 and small.nrows == 3
    assert small.to_pydict() == {"a": [0, 1, 2], "s": ["x", "x", "x"]}
    assert t.with_capacity(16384).to_pydict() == t.to_pydict()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(ExecutionError):
            resolve_device(None)
        with pytest.raises(ExecutionError):
            Table.from_pydict({"a": [1]})


def test_columnless_table_takes_the_given_device():
    """A Table with no columns lands where it is told; ``device=None`` means
    the card there too, so on a host without one it raises instead of
    landing on the CPU."""
    assert Table([], [], 0, device="cpu").device.type == "cpu"
    assert Table.empty(Schema([]), device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert Table([], [], 0).device.type == "cuda"
    else:
        with pytest.raises(ExecutionError):
            Table([], [], 0)
    # the engine passes its device to every column-less table it builds
    from datafusion_tpu_torch import ExecutionContext

    ctx = ExecutionContext(device="cpu")
    assert ctx.sql("SELECT 1 + 1 AS x").collect().to_pydict() == {"x": [2]}
    ctx.register_table("t", Table.from_pydict({"a": [1, 2, 3]}, device="cpu"))
    assert ctx.sql("SELECT count(*) AS c FROM t").collect().to_pydict() == {"c": [3]}
