"""stddev, stddev_pop, variance and var_pop in the torch port against the
JAX package on the CPU: grouped (the fused small-domain GROUP BY) and
ungrouped, over int, decimal and float columns with NULLs, on identical
buffers.

Tolerances, and why:
- variance and var_pop: exactly equal.  The data are chosen so that every
  sum the engines take is exact in float64 (integers below 1,000 and
  decimals and floats that are multiples of 1/4 and 1/8), so the order in
  which XLA and torch add the rows cannot show, and both engines then
  evaluate the same formula.  Floats with more bits differ in the last
  bits of the sums, in either engine, with the order of the adds.
- stddev and stddev_pop: relative 4.5e-16, 2 ulp.  torch 2.13.0+cpu's
  float64 sqrt is not correctly rounded for every input:
  torch.sqrt(torch.tensor(8.0, dtype=torch.float64)) gives
  2.82842712474619 where the correctly rounded square root, math.sqrt(8.0),
  is 2.8284271247461903.  The port takes the square root of a variance
  that equals the reference's exactly, so only the square root differs.
"""

import numpy as np
import pytest

import datafusion_tpu as J
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.types.dtypes import decimal as jdecimal
import datafusion_tpu_torch as D

from torch_parity import port_table

FUNCS = ["stddev", "stddev_pop", "variance", "var_pop"]
STDDEV_REL = 4.5e-16


@pytest.fixture(scope="module")
def contexts():
    rng = np.random.default_rng(11)
    n = 400

    def nulls(col, p=0.15):
        return [None if z else v for z, v in zip(rng.random(n) < p, col)]

    data = {
        "k": nulls(list(rng.choice(["a", "b", "c", "d"], n)), 0.1),
        "i": nulls([int(v) for v in rng.integers(-999, 1000, n)]),
        "d": nulls([float(v) / 4 for v in rng.integers(-1000, 1001, n)]),
        "f": nulls([float(v) / 8 for v in rng.integers(-1024, 1025, n)]),
    }
    # a group of one row (no sample variance), one of {2, 6} (sample
    # variance 8, whose square root torch rounds down) and one whose values
    # are all NULL
    for col, extra in (("k", ["e", "x", "x", "z", "z"]), ("i", [7, 2, 6, None, None]),
                       ("d", [2.25, 2.0, 6.0, None, None]), ("f", [-0.125, 2.0, 6.0, None, None])):
        data[col] = data[col] + extra
    jt = JTable.from_pydict(data, dtypes={"d": jdecimal(12, 2)})
    jctx = J.ExecutionContext()
    jctx.register_table("t", jt)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_table("t", port_table(jt))
    return jctx, pctx


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "ungrouped"])
@pytest.mark.parametrize("fn", FUNCS)
def test_variance_family_matches_jax(contexts, fn, grouped):
    jctx, pctx = contexts
    args = f"{fn}(i) AS a_i, {fn}(d) AS a_d, {fn}(f) AS a_f"
    sql = (f"SELECT k, {args} FROM t GROUP BY k ORDER BY k" if grouped
           else f"SELECT {args} FROM t WHERE i IS NULL OR i < 900")
    want = jctx.sql(sql).collect().to_pydict()
    got = pctx.sql(sql).collect().to_pydict()
    assert list(got) == list(want)
    if grouped:
        assert got["k"] == want["k"] == ["a", "b", "c", "d", "e", "x", "z", None]
    for col in ("a_i", "a_d", "a_f"):
        g, w = got[col], want[col]
        assert [x is None for x in g] == [y is None for y in w], col
        assert any(y is not None and y > 0 for y in w), col
        if fn.startswith("stddev"):
            for x, y in zip(g, w):
                if y is not None:
                    assert abs(x - y) <= STDDEV_REL * abs(y), (col, x, y)
        else:
            assert g == w, col
