"""The distributed runtime of the torch port against the JAX package's, on
TPC-H at SF 0.002 (the reference test's scale) and the port's query text
(``datafusion_tpu_torch/queries``; the JAX package's own TPC-H tests of
this layer read text it does not carry, ROADMAP fault F1).  Both engines
hold identical buffers (``torch_parity.port_table``).

  * The logical-plan serde round trip for all 22 queries, and the port's
    ``plan_to_dict`` equal to the JAX package's for the same SQL: the wire
    contract between processes.
  * The physical serde round trip of every stage of the Ballista set (Q1,
    Q3, Q5, Q6, Q10, Q12; benchmarks/run.sh:22-26), and each stage's
    ``pplan_to_dict`` equal to the JAX package's stage for stage.  The one
    difference by design is the job id, a fresh uuid per job in both
    engines, which the comparison sets aside.
  * The standalone cluster (2 executors, 3 partitions) gives the port's
    single-device rows for the six, with the reference test's own
    assertion (in order; floats rel 1e-9); Q1 and Q3 also give the JAX
    package's distributed rows (floats rel 1e-12 of max(|want|, 1)).
  * Distributed Q1 takes the small-domain path and calls K1 (its plain
    version here) once per scan task, in both engines.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import functools
import json

import pytest

import datafusion_tpu as J
import datafusion_tpu.distributed as JD
import datafusion_tpu.distributed.serde as jserde
import datafusion_tpu.physical.stage_compiler as jsc

import datafusion_tpu_torch as D
import datafusion_tpu_torch.distributed as PD
import datafusion_tpu_torch.distributed.serde as pserde
import datafusion_tpu_torch.ops.aggregate as pagg
from datafusion_tpu_torch.queries import FULLY_ORDERED, get_query_sql

from torch_mesh import assert_same_rows, jax_tables, one_torch_thread  # noqa: F401 (autouse fixture)
from torch_parity import Recorder, assert_rows_equal, port_table

BALLISTA_SET = [1, 3, 5, 6, 10, 12]
PARTITIONS = 3


@functools.lru_cache(maxsize=1)
def contexts():
    jctx = J.ExecutionContext()
    pctx = D.ExecutionContext(device="cpu")
    for name, t in jax_tables().items():
        jctx.register_table(name, t)
        pctx.register_table(name, port_table(t))
    return jctx, pctx


def statements(q: int) -> list:
    return [s for s in get_query_sql(q).split(";") if s.strip()]


def query_sql(q: int) -> str:
    (s,) = statements(q)
    return s


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_logical_plan_serde_roundtrip_and_wire_equal(q):
    jctx, pctx = contexts()
    for s in statements(q):
        if "create view" in s.lower() or "drop view" in s.lower():
            jctx.sql(s)
            pctx.sql(s)
            continue
        plan = pctx.optimize(pctx.create_logical_plan(s))
        d = pserde.plan_to_dict(plan)
        plan2 = pserde.plan_from_dict(d, lambda name, schema: pctx._resolve_table(name))
        # the round trip keeps structure and schema, and is a fixed point
        assert plan2.display() == plan.display()
        assert [f.qualified_name for f in plan2.schema().fields] == [
            f.qualified_name for f in plan.schema().fields
        ]
        assert pserde.plan_to_dict(plan2) == d
        # the wire contract: the JAX package ships the same dict
        want = jserde.plan_to_dict(jctx.optimize(jctx.create_logical_plan(s)))
        assert json.loads(json.dumps(d)) == json.loads(json.dumps(want))


def stage_plans(engine, serde, q: int) -> list:
    """The persisted stage plans of query q's job, job ids set aside."""
    jctx, pctx = contexts()
    ctx = jctx if engine is JD else pctx
    sched = engine.Scheduler(engine.SchedulerState(), work_dir="", target_partitions=2)
    for name in ctx.tables():
        sched.register_table_schema(name, ctx._resolve_table(name).schema())
    plan = ctx.optimize(ctx.create_logical_plan(query_sql(q)))
    job = sched.execute_query(serde.plan_to_dict(plan))
    out = []
    for sid in sched.state.job(job)["stage_ids"]:
        stage = sched.state.stage(job, sid)
        blob = json.dumps(stage["plan"])
        assert f'"job_id": "{job}"' in blob
        out.append(json.loads(blob.replace(job, "JOB")))
        p = serde.pplan_from_dict(json.loads(blob), None, "")
        assert isinstance(p, engine.ShuffleWriterExec)
        assert serde.pplan_to_dict(p) == stage["plan"]
    return out


@pytest.mark.parametrize("q", BALLISTA_SET)
def test_physical_plan_serde_roundtrip_and_stages_equal(q):
    got = stage_plans(PD, pserde, q)
    want = stage_plans(JD, jserde, q)
    assert len(got) == len(want)
    for sid, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"Q{q} stage {sid} differs"


def assert_reference_rows(got: dict, want: dict) -> None:
    """tests/test_distributed.py::test_standalone_tpch_distributed_set's
    assertion: the same columns and rows in order, floats rel 1e-9."""
    assert list(got) == list(want)
    for k in want:
        gv, wv = got[k], want[k]
        assert len(gv) == len(wv), f"{k}: {len(gv)} vs {len(wv)} rows"
        for a, b in zip(gv, wv):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-9)
            else:
                assert a == b


@pytest.fixture(scope="module")
def port_cluster():
    _, pctx = contexts()
    dctx = PD.DistributedContext(standalone=True, num_executors=2,
                                 target_partitions=PARTITIONS, device="cpu")
    for name in pctx.tables():
        dctx.register_table(name, pctx.table(name).collect())
    yield dctx
    dctx.close()


@pytest.mark.parametrize("q", BALLISTA_SET)
def test_standalone_tpch_distributed_set(q, port_cluster):
    _, pctx = contexts()
    sql = query_sql(q)
    got = port_cluster.sql(sql).collect().to_pydict()
    want = pctx.sql(sql).collect().to_pydict()
    assert len(next(iter(want.values()))) > 0
    assert_reference_rows(got, want)


@pytest.mark.parametrize("q", [1, 3])
def test_distributed_rows_equal_the_jax_package(q, port_cluster):
    jctx, _ = contexts()
    jd = JD.DistributedContext(standalone=True, num_executors=2, target_partitions=PARTITIONS)
    try:
        for name in jctx.tables():
            jd.register_table(name, jctx.table(name).collect())
        want = jd.sql(query_sql(q)).collect().to_pydict()
    finally:
        jd.close()
    got = port_cluster.sql(query_sql(q)).collect().to_pydict()
    floats = {k for k, v in want.items() if any(isinstance(x, float) for x in v)}
    if q in FULLY_ORDERED:
        assert_rows_equal(got, want, floats)
    else:
        assert_same_rows(got, want)


def test_distributed_q1_calls_k1_once_per_scan_task(monkeypatch):
    jrec = Recorder(jsc._fused_small_domain_aggregate)
    prec = Recorder(pagg._fused_small_domain_aggregate)
    k1 = Recorder(pagg.smalldomain_sum_count)
    monkeypatch.setattr(jsc, "_fused_small_domain_aggregate", jrec)
    monkeypatch.setattr(pagg, "_fused_small_domain_aggregate", prec)
    monkeypatch.setattr(pagg, "smalldomain_sum_count", k1)
    jctx, pctx = contexts()
    # one executor thread: the recorders count without a lock
    for engine, ctx, kw in ((JD, jctx, {}), (PD, pctx, {"device": "cpu"})):
        dctx = engine.DistributedContext(standalone=True, num_executors=1,
                                         target_partitions=PARTITIONS, **kw)
        try:
            dctx.register_table("lineitem", ctx.table("lineitem").collect())
            dctx.sql(query_sql(1)).collect()
            (key,) = dctx.scheduler.state.kv.keys("jobs/")
            job = key.split("/", 1)[1]
            scan = dctx.scheduler.state.stage(job, 0)
            assert scan["num_input_partitions"] == PARTITIONS
        finally:
            dctx.close()
    # every scan task's partial aggregate takes the small-domain path once;
    # the final aggregate merges states and does not
    assert jrec.calls == PARTITIONS
    assert prec.calls == PARTITIONS
    assert k1.calls == PARTITIONS
