"""A scalar subquery's cross join (``ops/join.py::cross_join_tables``)
broadcasts its one row across the other side's buffers, and the result
keeps that side's learned sizing: a consumer that right-sizes its input
(``Table.shrink_to_fit`` in ``TailStageExec`` and ``HashJoinExec``) then
reads no row count on the host inside a whole-query build, so the plan
becomes one unit.  The right-sizing reads only above
``SHRINK_SYNC_MIN_CAP`` rows (2^17), which the cross joins of TPC-H's Q22
and Q11 pass from about SF 3 and SF 4; here the threshold is lowered so
that small tables take the same path."""

import pytest

import datafusion_tpu_torch as D
from datafusion_tpu_torch import tpchdata
from datafusion_tpu_torch.ops import join as J
from datafusion_tpu_torch.physical import fuse as F
from datafusion_tpu_torch.queries import run_tpch

LOW = 64


@pytest.fixture(scope="module")
def tpch():
    return tpchdata.generate_tpch(0.01, 7)


@pytest.fixture
def low_threshold(monkeypatch):
    for mod in (J, F):
        monkeypatch.setattr(mod, "SHRINK_SYNC_MIN_CAP", LOW)


def _whole_query(ctx):
    return ctx._plan_cache[list(ctx._plan_cache)[-1]]._whole_query


@pytest.mark.parametrize("q", [11, 22])
def test_a_scalar_subquery_plan_becomes_one_unit(q, tpch, low_threshold):
    ctx = D.ExecutionContext(device="cpu")
    tpchdata.register_tpch(ctx, tpch)
    first = run_tpch(ctx, q).to_pydict()
    assert len(next(iter(first.values()))) > 0
    for _ in range(3):
        assert run_tpch(ctx, q).to_pydict() == first
    wq = _whole_query(ctx)
    assert wq.failure is None and wq.is_program


def test_the_broadcast_keeps_the_sizing_of_its_side():
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table("t", D.Table.from_pydict({"v": list(range(1000))}, device="cpu"))
    big = ctx.sql("SELECT v FROM t WHERE v > 10").collect()
    one = ctx.sql("SELECT avg(v) AS a FROM t").collect()
    for learned in (False, True):
        big._cap_learned = learned
        for lt, rt in ((big, one), (one, big)):
            out = J.cross_join_tables(lt, rt)
            assert out.capacity == big.capacity and out._cap_learned is learned
