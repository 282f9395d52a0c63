"""The 22 TPC-H queries in the torch port against the JAX package and the
pandas oracle on the CPU, at SF 0.01 (shared by test_torch_tpch_q01_q11.py
and test_torch_tpch_q12_q22.py, split so that each file stays short on one
test worker).

For each query, on ``bench.tpch_datagen``'s tables (seed 42):
  * the JAX package and the port, both running the port's query text
    (``datafusion_tpu_torch/queries``) on identical buffers, give the same
    rows in the same order, and take the same GROUP BY path: a recorder on
    each engine's ``_fused_small_domain_aggregate`` (through monkeypatch, on
    fresh stage caches so that the JAX package traces its stages anew); the
    port launches K1 (its plain version here) exactly when it takes that
    path;
  * the port, on its own generator's tables (``tpchdata``) and loader, gives
    ``bench/golden_pandas.py``'s rows (``bench/golden.py::compare_results``,
    ordered where ``FULLY_ORDERED`` says so, with ``ORDER_SPECS``).

Tolerances: against the JAX package, keys, counts, integer and decimal
sums, min and max are exact; float columns are within rel 1e-12 of
max(|want|, 1) (the engines add floats in other orders).  Against pandas,
compare_results' own rtol 1e-9 / atol 1e-6.
"""

from __future__ import annotations

import functools

import datafusion_tpu as J
import datafusion_tpu.physical.fuse as jfuse
import datafusion_tpu.physical.stage_compiler as jsc
from bench.golden import compare_results, table_to_rows
from bench.golden_pandas import pandas_query
from bench.tpch_datagen import DATE_COLUMNS, DECIMAL_COLUMNS, generate_tpch
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.types.dtypes import DATE32 as JDATE32, decimal as jdecimal

import datafusion_tpu_torch as D
import datafusion_tpu_torch.ops.aggregate as pagg
import datafusion_tpu_torch.physical.fuse as pfuse
from datafusion_tpu_torch import tpchdata
from datafusion_tpu_torch.queries import FULLY_ORDERED, ORDER_SPECS, run_tpch

from torch_parity import Recorder, assert_rows_equal, port_table

SF = 0.01


@functools.lru_cache(maxsize=1)
def bench_data() -> dict:
    return generate_tpch(SF)


@functools.lru_cache(maxsize=1)
def jax_tables() -> dict:
    """The eight tables as the JAX package's Tables, typed as
    ``bench/tpch.py::load_engine_tables`` types them."""
    out = {}
    for name, cols in bench_data().items():
        dtypes = {n: JDATE32 for n in cols if n in DATE_COLUMNS}
        dtypes.update({n: jdecimal(15, 2) for n in cols if n in DECIMAL_COLUMNS})
        out[name] = JTable.from_pydict(cols, dtypes=dtypes)
    return out


def float_columns(rows: dict) -> set:
    return {k for k, v in rows.items() if any(isinstance(x, float) for x in v)}


def check_against_jax(q: int, monkeypatch) -> None:
    jrec = Recorder(jsc._fused_small_domain_aggregate)
    prec = Recorder(pagg._fused_small_domain_aggregate)
    k1 = Recorder(pagg.smalldomain_sum_count)
    monkeypatch.setattr(jsc, "_fused_small_domain_aggregate", jrec)
    monkeypatch.setattr(pagg, "_fused_small_domain_aggregate", prec)
    monkeypatch.setattr(pagg, "smalldomain_sum_count", k1)
    monkeypatch.setattr(jfuse, "_STAGE_CACHE", {})
    monkeypatch.setattr(pfuse, "_STAGE_CACHE", {})
    jctx = J.ExecutionContext()
    pctx = D.ExecutionContext(device="cpu")
    for name, t in jax_tables().items():
        jctx.register_table(name, t)
        pctx.register_table(name, port_table(t))
    want = run_tpch(jctx, q).to_pydict()
    got = run_tpch(pctx, q).to_pydict()
    assert len(next(iter(want.values()))) > 0
    assert_rows_equal(got, want, float_columns(want))
    assert (prec.calls > 0) == (jrec.calls > 0), (q, prec.calls, jrec.calls)
    assert (k1.calls > 0) == (prec.calls > 0), (q, k1.calls, prec.calls)


def check_against_pandas(q: int) -> None:
    ctx = D.ExecutionContext(device="cpu")
    tpchdata.register_tpch(ctx, tpchdata.generate_tpch(SF))
    rows = table_to_rows(run_tpch(ctx, q))
    err = compare_results(
        rows, pandas_query(bench_data(), q), ordered=q in FULLY_ORDERED, order_spec=ORDER_SPECS.get(q)
    )
    assert err is None, (q, err)
