"""Columnar layer of the torch port (datafusion_tpu_torch/columnar): tables
carried over from the JAX package with ``table_from_host`` and tables built
by ``Table.from_pydict`` must match the JAX package's Tables in capacity,
storage buffers, vrange and decoded rows; ``to_pydict``'s whole-column
conversions must give the JAX package's per-value loop's Python values,
type for type, for every dtype, null pattern and value range."""

import datetime as dt
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.columnar.column import Column as JColumn
from datafusion_tpu.columnar.dictionary import StringDict as JStringDict
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.types.dtypes import DATE32, FLOAT64, INT64, STRING, decimal
from datafusion_tpu.types.dtypes import DataType as JDataType
from datafusion_tpu_torch.columnar.column import Column, list_null_sentinel
from datafusion_tpu_torch.columnar.convert import dtype_from_kind, table_from_host
from datafusion_tpu_torch.columnar.dictionary import StringDict
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


# ---- to_pydict: whole-column conversions against the JAX package's loop ----

_EPOCH = dt.date(1970, 1, 1)
_DAY_MIN = (dt.date.min - _EPOCH).days
_DAY_MAX = (dt.date.max - _EPOCH).days
_US_EDGE = 2**32 * 10**6  # timestamps convert whole within (-_US_EDGE, _US_EDGE)
_WORDS = np.array(sorted(["", "a", "B", "z" * 40, "ünï", "x y", "42", "Customer#000000007"]), dtype=object)


def _jax_dtype(t: P.DataType) -> JDataType:
    elem = None if t.elem is None else _jax_dtype(t.elem)
    return JDataType(t.kind, t.precision, t.scale, t.tz, elem, t.list_size)


def _tables(cols: dict, n: int) -> tuple[Table, JTable]:
    """The port's Table and the JAX package's over the same host arrays;
    ``cols`` maps a name to (dtype, data, valid).  Without a list column
    the port's table is ``port_table`` of the JAX package's."""
    jcols, pcols = [], []
    for t, data, valid in cols.values():
        words = _WORDS if t.is_string or (t.is_list and t.elem.is_string) else None
        jcols.append(JColumn(_jax_dtype(t), jnp.asarray(data), jnp.asarray(valid),
                             None if words is None else JStringDict(words)))
        pcols.append(Column(t, torch.from_numpy(data.copy()), torch.from_numpy(valid.copy()),
                            None if words is None else StringDict(words)))
    j = JTable(list(cols), jcols, n)
    if any(t.is_list for t, _, _ in cols.values()):
        return Table(list(cols), pcols, n, device="cpu"), j
    return port_table(j), j


def _assert_typed_equal(got, want, where=()):
    """Equal values of the same Python type (NaN equal to NaN, -0.0 told
    from 0.0), lists compared element by element."""
    assert type(got) is type(want), (where, got, want)
    if isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_typed_equal(g, w, where + (i,))
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), (where, got)
    else:
        assert got == want, (where, got, want)
        if isinstance(want, float):
            assert math.copysign(1.0, got) == math.copysign(1.0, want), (where, got, want)


def _assert_decodes_alike(cols: dict, n: int):
    p, j = _tables(cols, n)
    got, want = p.to_pydict(), j.to_pydict()
    assert list(got) == list(want) == list(cols)
    for k in want:
        _assert_typed_equal(got[k], want[k], (k,))


def _storage(t: P.DataType, n: int, rng) -> np.ndarray:
    """``n`` live storage values of ``t`` across its range, its ends first."""
    st = t.storage_np_dtype()
    if t.is_string:
        return rng.integers(0, len(_WORDS), n).astype(st)
    if t.kind == "date32":
        return np.concatenate([[_DAY_MIN, _DAY_MAX, 0, -1], rng.integers(_DAY_MIN, _DAY_MAX, n)])[:n].astype(st)
    if t.kind == "timestamp":
        e = _US_EDGE - 1
        return np.concatenate([[-e, e, 0, -1], rng.integers(-e, e, n)])[:n].astype(st)
    if t.is_decimal:
        return rng.integers(-(10**15), 10**15, n).astype(st)
    if st == np.bool_:
        return rng.random(n) < 0.5
    if st.kind == "f":
        special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, np.finfo(st).max, np.finfo(st).tiny])
        return np.concatenate([special, rng.normal(size=n) * 10.0 ** rng.integers(-20, 20, n)])[:n].astype(st)
    info = np.iinfo(st)
    return np.concatenate([np.array([info.min, info.max], st), rng.integers(info.min, info.max, n, dtype=st, endpoint=True)])[:n]


def _nulls(pattern: str, n: int, rng) -> np.ndarray:
    if pattern == "none":
        return np.ones(n, bool)
    if pattern == "all":
        return np.zeros(n, bool)
    return rng.random(n) < 0.7


def _garbage(data: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """``data`` with the null rows set to the storage's lowest value (out of
    every conversion's range, and a code no dictionary has)."""
    data = data.copy()
    if data.dtype != np.bool_:
        low = np.finfo(data.dtype).min if data.dtype.kind == "f" else np.iinfo(data.dtype).min
        data[~valid] = low
    return data


_KINDS = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float32", "float64", "decimal(15,2)", "date32", "timestamp", "interval_ym",
          "interval_dt", "string", "null"]


def test_kinds_cover_every_storage_dtype():
    """Every kind of the port's type constants has a case below."""
    kinds = {v.kind for v in vars(P).values() if isinstance(v, P.DataType)}
    assert kinds <= {k.split("(")[0] for k in _KINDS}


@pytest.mark.parametrize("nulls", ["none", "some", "all", "empty"])
@pytest.mark.parametrize("kind", _KINDS)
def test_to_pydict_matches_jax_per_dtype(kind, nulls):
    rng = np.random.default_rng(len(kind) * 7 + len(nulls))
    n = 0 if nulls == "empty" else 300
    t = dtype_from_kind(kind)
    valid = _nulls(nulls, n, rng)
    _assert_decodes_alike({"c": (t, _garbage(_storage(t, n, rng), valid), valid)}, n)


@pytest.mark.parametrize("elem", ["int32", "int64", "float32", "float64", "decimal(15,2)", "date32",
                                  "timestamp", "string", "bool"])
def test_to_pydict_matches_jax_fixed_size_lists(elem):
    """Row nulls and element nulls (the in-band sentinels), k = 3 and 0."""
    rng = np.random.default_rng(len(elem))
    n, e = 200, dtype_from_kind(elem)
    valid = _nulls("some", n, rng)
    cols = {}
    for k in (3, 0):
        t = P.DataType("fixed_size_list", elem=e, list_size=k)
        data = _storage(e, n * k, rng).reshape(n, k)
        data[rng.random((n, k)) < 0.2] = list_null_sentinel(e)
        cols[f"k{k}"] = (t, data, valid)
    _assert_decodes_alike(cols, n)


@pytest.mark.parametrize("side", ["within", "past"])
@pytest.mark.parametrize("scale", [0, 2, 4, 6, 24])
def test_to_pydict_matches_jax_decimals_around_2_53(scale, side):
    """Decimals take float64 division within |v| <= 2**53 and a scale of at
    most 22, the exact per-value path past either: the same floats."""
    rng = np.random.default_rng(scale)
    edge = [2**53, -(2**53), 2**53 - 1, 1 - 2**53, 0, 1, -1]
    if side == "past":
        edge += [2**53 + 1, -(2**53) - 1, 2**63 - 1, 3 * 2**60 + 7]
    lim = 2**53 if side == "within" else 2**63 - 1
    data = np.concatenate([edge, rng.integers(-lim, lim, 400)]).astype(np.int64)
    valid = np.ones(len(data), bool)
    valid[-5:] = False
    t = P.decimal(18, scale)
    _assert_decodes_alike({"d": (t, data, valid)}, len(data))


@pytest.mark.parametrize("case", ["ends", "below", "above"])
def test_to_pydict_matches_jax_dates_at_range_ends(case):
    """date32 at datetime.date's first and last day; one day outside
    raises OverflowError in both, as the per-value loop does."""
    rng = np.random.default_rng(5)
    data = np.array([_DAY_MIN, _DAY_MAX, 0, -1, 1] + rng.integers(_DAY_MIN, _DAY_MAX, 100).tolist(), np.int32)
    valid = np.ones(len(data), bool)
    if case == "ends":
        _assert_decodes_alike({"d": (P.DATE32, data, valid)}, len(data))
        return
    data[3] = _DAY_MIN - 1 if case == "below" else _DAY_MAX + 1
    for table in _tables({"d": (P.DATE32, data, valid)}, len(data)):
        with pytest.raises(OverflowError):
            table.to_pydict()


@pytest.mark.parametrize("side", ["within", "past"])
def test_to_pydict_matches_jax_timestamps_around_the_edge(side):
    """Timestamps convert whole within 2**32 s of the epoch, where
    ``fromtimestamp(v / 1e6)`` rounds back to ``v``; past it, value by
    value (years 1000 to 9000)."""
    rng = np.random.default_rng(11)
    e = _US_EDGE - 1
    if side == "within":
        data = [-e, e, 1 - e, e - 1, -1, 1] + rng.integers(-e, e, 500).tolist()
        data += rng.integers(e - 10**7, e, 200).tolist() + rng.integers(-e, 10**7 - e, 200).tolist()
    else:
        lo, hi = -30610224000 * 10**6, 221845392000 * 10**6
        data = [e + 1, -e - 1, lo, hi] + rng.integers(lo, hi, 500).tolist()
    data = np.array(data, np.int64)
    _assert_decodes_alike({"ts": (P.TIMESTAMP_US, data, np.ones(len(data), bool))}, len(data))


def test_to_pydict_matches_jax_q1_sum_charge():
    """Q1's four money sums at scale 6 (sum_charge at SF10 reaches about
    5.7e17 micro-dollars, past 2**53): the exact path, the same floats."""
    data = np.array([565_865_544_007_299_820, 14_804_077_086_961_238,
                     1_117_681_934_418_062_912, 565_680_954_341_436_080], np.int64)
    _assert_decodes_alike({"sum_charge": (P.decimal(18, 6), data, np.ones(4, bool))}, 4)
