"""DistributedContext: the BallistaContext equivalent.

Port of ``datafusion_tpu/distributed/context.py``.  As Ballista's
client/src/context.rs:97: a SQL / DataFrame facade that registers tables
client-side, ships serialized logical plans to the scheduler
(ExecuteQuery), polls GetJobStatus, and fetches completed final-stage
partitions.  `standalone` mode runs the scheduler plus N executors inside
the client process (context.rs:83-115 + state/standalone.rs), which is
also the test harness of the whole distributed FSM: no cluster required.

``device`` (None: the card) is where the registered tables, the
executors' work and the fetched results live; its planning
``ExecutionContext`` is built on it, so ``tpchdata.register_tpch`` takes
this context as it takes an ``ExecutionContext``.  The executors run in
threads of this process (see ``executor.py`` on what must not run beside
them).
"""

from __future__ import annotations

import tempfile
import time

from ..columnar.table import Table
from ..device import resolve_device
from ..errors import ExecutionError, PlanError
from ..execution.context import ExecutionContext
from . import serde, shuffle_io
from .exchange import TableStore, add_times
from .executor import Executor
from .scheduler import Scheduler
from .state import SchedulerState


class DistributedContext:
    def __init__(
        self,
        standalone: bool = True,
        num_executors: int = 2,
        target_partitions: int = 4,
        work_dir: str | None = None,
        mesh_devices: int | None = None,
        device=None,
    ):
        if not standalone:
            raise PlanError(
                "only standalone (in-proc) clusters are supported in-process; "
                "multi-host mode uses rpc.serve_scheduler/rpc.run_executor"
            )
        self.device = resolve_device(device)
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="dftpu_shuffle_")
        self.store = TableStore(device=self.device)
        self.scheduler = Scheduler(
            SchedulerState(work_dir=self.work_dir),
            work_dir=self.work_dir,
            target_partitions=target_partitions,
        )
        self.executors = [
            Executor(
                f"executor-{i}", self.scheduler, self.store,
                mesh_devices=mesh_devices, device=self.device,
            )
            for i in range(num_executors)
        ]
        for e in self.executors:
            e.start()
        # a local context for parsing/optimizing (the client embeds a full
        # planning stack, as BallistaContext embeds DataFusion)
        self._planning_ctx = ExecutionContext(device=self.device)

    def close(self):
        for e in self.executors:
            e.stop()

    # ---- registration (client-side, context.rs:97+) -----------------------
    def register_table(self, name: str, table: Table):
        table = table.to(self.device)
        self.store.put(name, table)
        self._planning_ctx.register_table(name, table)
        self.scheduler.register_table_schema(name, table.schema())

    def register_csv(self, name: str, path: str, **kw):
        self._planning_ctx.register_csv(name, path, **kw)
        t = self._planning_ctx.table(name).collect()
        self.store.put(name, t)
        self.scheduler.register_table_schema(name, t.schema())

    def register_parquet(self, name: str, path: str):
        self._planning_ctx.register_parquet(name, path)
        t = self._planning_ctx.table(name).collect()
        self.store.put(name, t)
        self.scheduler.register_table_schema(name, t.schema())

    def tables(self) -> list[str]:
        return self.store.names()

    # ---- query ---------------------------------------------------------------
    def sql(self, query: str) -> "DistributedDataFrame":
        plan = self._planning_ctx.create_logical_plan(query)
        plan = self._planning_ctx.optimize(plan)
        return DistributedDataFrame(self, plan)

    def execute_logical_plan(self, plan) -> Table:
        # ship over the serde contract (ExecuteQuery's proto round-trip)
        plan_dict = serde.plan_to_dict(plan)
        job_id = self.scheduler.execute_query(plan_dict)
        out = self._await_job(job_id)
        # final output uses unqualified display names (same as the local
        # ExecutionContext.collect contract)
        display = [f.name for f in plan.schema().fields]
        if len(display) == len(out.names):
            out = Table(display, out.columns, out.nrows, device=out.device)
        return out

    def _await_job(self, job_id: str, timeout_s: float = 300.0) -> Table:
        t0 = time.time()
        while True:
            status = self.scheduler.get_job_status(job_id)
            if status["status"] == "COMPLETED":
                r0 = time.perf_counter()
                out = shuffle_io.concat_read(
                    status["final_paths"], status["final_schema"], self.device
                )
                add_times(final_read_s=time.perf_counter() - r0)
                return out
            if status["status"] == "FAILED":
                raise ExecutionError(f"job {job_id} failed: {status['error']}")
            if time.time() - t0 > timeout_s:
                raise ExecutionError(f"job {job_id} timed out")
            time.sleep(0.005)
            add_times(await_sleep_s=0.005)


class DistributedDataFrame:
    """Lazy handle: logical plan + owning context (BallistaDataFrame)."""

    def __init__(self, ctx: DistributedContext, plan):
        self.ctx = ctx
        self.plan = plan

    def logical_plan(self):
        return self.plan

    def collect(self) -> Table:
        return self.ctx.execute_logical_plan(self.plan)

    def explain(self) -> str:
        return self.plan.display()
