"""Helpers shared by the torch-port parity tests (tests/test_torch_*.py):
move a JAX-package Table's buffers into the torch engine unchanged, so
both engines run on identical inputs."""

from __future__ import annotations

import math

import numpy as np

from datafusion_tpu_torch.columnar.convert import table_from_host


def kind_of(dtype) -> str:
    """The ``table_from_host`` kind string of a DataType."""
    if dtype.is_decimal:
        return f"decimal({dtype.precision},{dtype.scale})"
    return dtype.kind


def jax_table_to_host(t):
    """(names, kinds, datas, valids, dictionaries, nrows) of a JAX Table."""
    return (
        list(t.names),
        [kind_of(c.dtype) for c in t.columns],
        [np.asarray(c.data) for c in t.columns],
        [np.asarray(c.valid) for c in t.columns],
        [None if c.dictionary is None else c.dictionary.values for c in t.columns],
        t.nrows,
    )


def port_table(jax_table, device="cpu"):
    """The torch engine's copy of a JAX Table."""
    return table_from_host(*jax_table_to_host(jax_table), device=device)


def assert_pydict_parity(got: dict, want: dict, rel: float = 0.0, float_cols=None) -> None:
    """Equal column names and values.  The float columns named in
    ``float_cols`` (default: those whose name starts with ``avg``) may
    differ by ``rel`` relative to max(|want|, 1); every other column,
    decimal sums included, must be exactly equal."""
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert len(g) == len(w), k
        tolerant = k in float_cols if float_cols is not None else k.startswith("avg")
        if rel and tolerant:
            for x, y in zip(g, w):
                assert (x is None) == (y is None), k
                if y is not None:
                    assert abs(x - y) <= rel * max(abs(y), 1.0), (k, x, y)
        else:
            assert g == w, (k, g, w)


REL = 1e-12


def _same(x, y, tolerant: bool) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(y, float):
        if math.isnan(y):
            return isinstance(x, float) and math.isnan(x)
        if tolerant:
            return abs(x - y) <= REL * max(abs(y), 1.0)
        return x == y and math.copysign(1.0, x) == math.copysign(1.0, y)
    return x == y


def assert_rows_equal(got: dict, want: dict, float_cols=()) -> None:
    """Equal columns and rows, in order.  Values are exactly equal (NaN
    equal to NaN, -0.0 told from 0.0) but in ``float_cols``, which may
    differ by rel 1e-12 relative to max(|want|, 1)."""
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for x, y in zip(got[k], want[k]):
            assert _same(x, y, k in float_cols), (k, x, y)


class Recorder:
    """Wraps a function and counts its calls (for monkeypatching a module's
    function to learn which path a query took)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)
