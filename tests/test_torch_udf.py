"""User-defined functions and aggregates (datafusion_tpu_torch/functions/
udf.py, ``PhysScalarUDF``, the UDAF's segmented scan) against the JAX
package: the six tests of tests/test_udf.py, each run in both engines with
each engine's own function bodies for the same arithmetic (jnp for the
reference, torch for the port; ``torch.clamp_min`` where the reference
uses ``jnp.maximum``), rows equal; and a UDAF through the morsels of a
host-resident table, in both engines and against numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as J
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.functions import udf as judf
from datafusion_tpu.types import dtypes as JT
import datafusion_tpu_torch as D
from datafusion_tpu_torch.functions import udf as pudf
from datafusion_tpu_torch.physical import fuse as pfuse
from datafusion_tpu_torch.types import dtypes as PT
from datafusion_tpu.physical import fuse as jfuse

from torch_parity import port_table

DATA = {"g": ["a", "a", "b", "b", "b"], "x": [1, 2, 3, None, 5]}


@pytest.fixture()
def both(monkeypatch):
    """(JAX context, port context) over test_udf.py's table, with fresh
    stage caches (their keys leave out a UDF's identity: fault F8)."""
    monkeypatch.setattr(jfuse, "_STAGE_CACHE", {})
    monkeypatch.setattr(pfuse, "_STAGE_CACHE", {})
    jt = JTable.from_pydict(DATA)
    jctx = J.ExecutionContext()
    jctx.register_table("t", jt)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_table("t", port_table(jt))
    return jctx, pctx


def _register(ctx, kind, *args, **kw):
    mod, T = (judf, JT) if isinstance(ctx, J.ExecutionContext) else (pudf, PT)
    make = mod.create_udf if kind == "udf" else mod.create_udaf
    fn = make(*[getattr(T, a) if isinstance(a, str) and a.isupper() else a for a in args], **kw)
    (ctx.register_udf if kind == "udf" else ctx.register_udaf)(fn)


def _rows(both, sql):
    jctx, pctx = both
    want = jctx.sql(sql).collect().to_pydict()
    got = pctx.sql(sql).collect().to_pydict()
    assert got == want
    return got


def test_scalar_udf(both):
    for ctx in both:
        _register(ctx, "udf", "plus_one", ["INT64"], "INT64", lambda x: x + 1)
    assert _rows(both, "SELECT plus_one(x) AS y FROM t ORDER BY y NULLS LAST") == {"y": [2, 3, 4, 6, None]}


def test_scalar_udf_two_args_null_propagation(both):
    for ctx in both:
        _register(ctx, "udf", "mul_add", ["INT64", "INT64"], "INT64", lambda a, b: a * 10 + b)
    got = _rows(both, "SELECT g, mul_add(x, x) AS y FROM t ORDER BY g, y NULLS LAST")
    assert got["y"] == [11, 22, 33, 55, None]


def test_scalar_udf_in_where_and_projection(both):
    for ctx in both:
        _register(ctx, "udf", "sq", ["INT64"], "INT64", lambda x: x * x)
    assert _rows(both, "SELECT sum(sq(x)) AS s FROM t WHERE sq(x) > 1") == {"s": [38]}


def test_udaf_grouped(both):
    for ctx in both:
        _register(ctx, "udaf", "sum_sq", "INT64", "INT64", zero=0, step=lambda a, b: a + b)
        _register(ctx, "udf", "sq", ["INT64"], "INT64", lambda x: x * x)
    got = _rows(both, "SELECT g, sum_sq(sq(x)) AS ss FROM t GROUP BY g ORDER BY g")
    assert got == {"g": ["a", "b"], "ss": [5, 34]}


def test_udaf_product_no_group(both):
    for ctx in both:
        _register(ctx, "udaf", "product", "INT64", "INT64", zero=1, step=lambda a, b: a * b)
    assert _rows(both, "SELECT product(x) AS p FROM t") == {"p": [30]}


def test_udaf_with_finalize(both):
    jctx, pctx = both
    _register(jctx, "udaf", "geo_mean_log", "FLOAT64", "FLOAT64", zero=0.0, step=lambda a, b: a + b,
              finalize=lambda acc, cnt: acc / jnp.maximum(cnt, 1))
    _register(pctx, "udaf", "geo_mean_log", "FLOAT64", "FLOAT64", zero=0.0, step=lambda a, b: a + b,
              finalize=lambda acc, cnt: acc / torch.clamp_min(cnt, 1))
    got = _rows(both, "SELECT g, geo_mean_log(x) AS m FROM t GROUP BY g ORDER BY g")
    assert got["m"] == [pytest.approx(1.5), pytest.approx(4.0)]


def test_udaf_through_morsels(monkeypatch):
    """A UDAF's (accumulator, count) states merge across the morsels of a
    host-resident table: grouped and not, with a scalar UDF under it, in
    both engines and against numpy."""
    monkeypatch.setattr(jfuse, "_STAGE_CACHE", {})
    monkeypatch.setattr(pfuse, "_STAGE_CACHE", {})
    rng = np.random.default_rng(3)
    n = 5000
    data = {"g": rng.integers(0, 6, n).astype(np.int64), "x": rng.integers(-4, 5, n).astype(np.int64)}
    jt = JTable.from_pydict(data)
    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    jctx.register_host_table("t", jt, morsel_rows=1024)
    pctx.register_host_table("t", port_table(jt), morsel_rows=1024)
    for ctx in (jctx, pctx):
        _register(ctx, "udf", "sq", ["INT64"], "INT64", lambda x: x * x)
        _register(ctx, "udaf", "ssum", "INT64", "INT64", zero=0, step=lambda a, b: a + b)
    _register(jctx, "udaf", "mx", "INT64", "INT64", zero=-(2**62), step=lambda a, b: jnp.maximum(a, b))
    _register(pctx, "udaf", "mx", "INT64", "INT64", zero=-(2**62), step=lambda a, b: torch.maximum(a, b))
    q = "SELECT g, ssum(sq(x)) s, mx(x) m FROM t GROUP BY g ORDER BY g"
    got = _rows((jctx, pctx), q)
    assert got["s"] == [int((data["x"][data["g"] == g] ** 2).sum()) for g in range(6)]
    assert got["m"] == [int(data["x"][data["g"] == g].max()) for g in range(6)]
    assert _rows((jctx, pctx), "SELECT ssum(sq(x)) s FROM t") == {"s": [int((data["x"] ** 2).sum())]}
    assert "MorselStageExec" in pctx.sql(f"EXPLAIN {q}").collect().to_pydict()["plan"][-1]
