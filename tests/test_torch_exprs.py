"""Physical expressions of the torch port (datafusion_tpu_torch/exprs):
TPC-H Q1's expressions, casts and three-valued logic, bound by each
engine's own SQL front end and physical planner and evaluated on identical
buffers (with NULLs) by the JAX package and by the port.  The data and
validity buffers must be exactly equal up to nrows."""

import numpy as np
import pytest

import datafusion_tpu as J
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.physical.planner import create_physical_expr as jax_bind
from datafusion_tpu.types.dtypes import DATE32, FLOAT64, INT64, STRING, decimal
import datafusion_tpu_torch as D
from datafusion_tpu_torch.physical.planner import create_physical_expr as port_bind

from torch_parity import port_table

N = 3000


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(11)

    def nulls(col, p=0.1):
        return [None if z else v for z, v in zip(rng.random(N) < p, col)]

    days = rng.integers(8000, 10800, N)
    data = {
        "l_quantity": nulls(rng.integers(1, 51, N).astype(float)),
        "l_extendedprice": nulls(rng.integers(90_000, 10_500_000, N) / 100),
        "l_discount": nulls(rng.integers(0, 11, N) / 100),
        "l_tax": nulls(rng.integers(0, 9, N) / 100),
        "l_returnflag": nulls(rng.choice(["A", "N", "R"], N)),
        "l_linestatus": nulls(rng.choice(["F", "O"], N)),
        "l_shipdate": np.where(
            rng.random(N) < 0.1, np.datetime64("NaT"),
            np.datetime64("1970-01-01", "D") + days.astype("timedelta64[D]"),
        ),
        "i": nulls([int(v) for v in rng.integers(-1000, 1000, N)]),
        "f": nulls(rng.normal(size=N) * 100),
        "b": nulls([bool(v) for v in rng.random(N) < 0.5], 0.2),
    }
    dtypes = {
        "l_quantity": decimal(15, 2),
        "l_extendedprice": decimal(15, 2),
        "l_discount": decimal(15, 2),
        "l_tax": decimal(15, 2),
        "l_returnflag": STRING,
        "l_linestatus": STRING,
        "l_shipdate": DATE32,
        "i": INT64,
        "f": FLOAT64,
    }
    jt = JTable.from_pydict(data, dtypes=dtypes)
    jctx = J.ExecutionContext()
    jctx.register_table("t", jt)
    pt = port_table(jt)
    pctx = D.ExecutionContext(device="cpu")
    pctx.register_table("t", pt)
    return jctx, jt, pctx, pt


def _eval(ctx, bind, table, expr):
    plan = ctx.create_logical_plan(f"SELECT {expr} AS x FROM t")
    pe = bind(plan.exprs[0], plan.input.schema())
    return pe.evaluate(table)


EXPRS = [
    # TPC-H Q1
    "l_extendedprice * (1 - l_discount)",
    "l_extendedprice * (1 - l_discount) * (1 + l_tax)",
    "l_shipdate <= date '1998-09-02'",
    "l_returnflag = 'A'",
    "l_returnflag < l_linestatus",
    # decimal arithmetic and comparisons
    "l_quantity + l_tax",
    "l_quantity - l_extendedprice",
    "l_quantity / l_discount",
    "l_quantity % l_tax",
    "l_discount > 0.05",
    "l_discount = 0.05",
    "l_quantity >= l_extendedprice",
    "l_quantity + i",
    # casts between integer, decimal, date32 and float64
    "cast(l_quantity as bigint)",
    "cast(l_quantity as double)",
    "cast(l_discount as decimal(15,4))",
    "cast(l_extendedprice as decimal(15,1))",
    "cast(i as decimal(12,2))",
    "cast(f as decimal(12,3))",
    "cast(i as double)",
    "cast(f as bigint)",
    "cast(l_shipdate as timestamp)",
    "l_shipdate >= cast('1995-01-01' as date)",
    # integer and float arithmetic
    "i / 7",
    "i % 7",
    "i * i - 3",
    "f / f",
    "f % 3.5",
    "f < i",
    # three-valued logic
    "(l_shipdate <= date '1998-09-02') and (l_discount > 0.05)",
    "(l_shipdate <= date '1998-09-02') or b",
    "b and (i > 0)",
    "not (i > 0)",
    "not b",
    "l_tax is null",
    "l_tax is not null",
    "i between -10 and 10",
]


@pytest.mark.parametrize("expr", EXPRS)
def test_expression_parity(tables, expr):
    jctx, jt, pctx, pt = tables
    jc = _eval(jctx, jax_bind, jt, expr)
    pc = _eval(pctx, port_bind, pt, expr)
    assert repr(pc.dtype) == repr(jc.dtype)
    np.testing.assert_array_equal(pc.valid[:N].numpy(), np.asarray(jc.valid)[:N])
    np.testing.assert_array_equal(pc.data[:N].numpy(), np.asarray(jc.data)[:N])


def test_uint64_division_as_the_reference():
    """Fault F6 belongs to the reference: ``/`` and ``%`` on a uint64
    column give INT64 values computed on the int64 bits, in the JAX package
    and in the port alike (for 2^63 + 5: -3074457345618258601 and -3)."""
    u = np.array([2**63 + 5, 5, 2**64 - 1, 2**63 - 1], np.uint64)
    jt = JTable.from_pydict({"u": u})
    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    jctx.register_table("t", jt)
    pctx.register_table("t", port_table(jt))
    sql = "SELECT u / 3 AS q, u % 7 AS r FROM t"
    want = jctx.sql(sql).collect()
    got = pctx.sql(sql).collect()
    assert [repr(c.dtype) for c in got.columns] == [repr(c.dtype) for c in want.columns]
    assert got.to_pydict() == want.to_pydict()
    assert got.to_pydict()["q"][0] == -3074457345618258601
    assert got.to_pydict()["r"][0] == -3
