"""TPC-H Q1-Q11 in the torch port against the JAX package and the pandas
oracle on the CPU at SF 0.01 (see tests/torch_tpch.py for what each check
compares and its tolerance); and the port's TPC-H generator and loader
against ``bench``'s."""

import numpy as np
import pytest

from bench.tpch_datagen import generate_tpch
import datafusion_tpu_torch as D
from datafusion_tpu_torch import tpchdata

from torch_parity import port_table
from torch_tpch import SF, bench_data, check_against_jax, check_against_pandas, jax_tables

QUERIES = range(1, 12)


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_query_matches_jax(q, monkeypatch):
    check_against_jax(q, monkeypatch)


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_query_matches_pandas(q):
    check_against_pandas(q)


@pytest.mark.parametrize("sf,seed", [(SF, 42), (0.002, 7)])
def test_generator_equals_bench(sf, seed):
    want = generate_tpch(sf, seed) if (sf, seed) != (SF, 42) else bench_data()
    got = tpchdata.generate_tpch(sf, seed)
    assert list(got) == list(want)
    for t in want:
        assert list(got[t]) == list(want[t]), t
        for c in want[t]:
            g, w = got[t][c], want[t][c]
            assert g.dtype == w.dtype and g.shape == w.shape, (t, c)
            assert np.array_equal(g, w), (t, c)


def test_loader_types_as_bench():
    """register_tpch gives each table the types, buffers and dictionaries
    of the JAX package's tables loaded as bench/tpch.py loads them."""
    ctx = D.ExecutionContext(device="cpu")
    tpchdata.register_tpch(ctx, tpchdata.generate_tpch(SF))
    for name, jt in jax_tables().items():
        got = ctx.table(name).collect()
        want = port_table(jt)
        assert got.names == want.names
        for g, w in zip(got.columns, want.columns):
            assert str(g.dtype) == str(w.dtype)
        assert got.to_pydict() == want.to_pydict(), name
