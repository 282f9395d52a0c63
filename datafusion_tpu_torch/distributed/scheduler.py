"""Scheduler service: plan jobs into stage DAGs, hand out tasks.

Port of ``datafusion_tpu/distributed/scheduler.py`` (host logic).
Equivalent of Ballista's SchedulerGrpc service
(ballista/rust/scheduler/src/lib.rs:170-497):
  execute_query  (:312)  decode logical plan -> physical plan
                         -> DistributedPlanner stage split -> persist
                         job/stage/task state
  poll_work      (:170)  executor heartbeat + pull-based task assignment;
                         resolves UnresolvedShuffleExec against completed
                         stage locations at hand-out time
  get_job_status         job FSM + final-stage partition locations

Transport is direct method calls (standalone) or the JSON-over-TCP wrapper
in `rpc.py` (several processes).  The scheduler plans and decodes plans
but never executes one, and never opens a device: it runs in a process
with no card.
"""

from __future__ import annotations

import threading
import uuid

from ..errors import PlanError
from ..physical.planner import DefaultPhysicalPlanner
from . import serde
from .exchange import ShuffleWriterExec, TableStore
from .planner import DistributedPlanner, remove_unresolved_shuffles
from .state import SchedulerState


class RefTable:
    """Planning-time table provider that scans to a by-name DistScanExec —
    the scheduler never holds table data, only schemas."""

    def __init__(self, name: str, schema, num_partitions: int):
        self.name = name
        self._schema = schema
        self.num_partitions = num_partitions

    def schema(self):
        return self._schema

    def statistics(self):
        from ..datasource.datasource import Statistics

        return Statistics()

    def supports_filter_pushdown(self, expr) -> bool:
        return False

    def scan(self, projection=None, filters=None, limit=None, table_name=""):
        from .exchange import DistScanExec

        return DistScanExec(
            self.name, self._schema, projection, self.num_partitions
        )


class Scheduler:
    def __init__(
        self,
        state: SchedulerState | None = None,
        work_dir: str = "",
        target_partitions: int = 4,
    ):
        self.state = state if state is not None else SchedulerState()
        self.work_dir = work_dir
        self.target_partitions = target_partitions
        self._tables: dict[str, RefTable] = {}
        self._lock = threading.RLock()

    # ---- catalog (client-side registration, BallistaContext style) --------
    def register_table_schema(self, name: str, schema) -> None:
        self._tables[name] = RefTable(name, schema, self.target_partitions)

    def _resolver(self, name: str, schema):
        t = self._tables.get(name)
        if t is None:
            # trust the shipped schema (client registered data with executors)
            t = RefTable(name, schema, self.target_partitions)
            self._tables[name] = t
        return t

    # ---- ExecuteQuery ------------------------------------------------------
    def execute_query(self, logical_plan_dict: dict) -> str:
        job_id = uuid.uuid4().hex[:12]
        plan = serde.plan_from_dict(logical_plan_dict, self._resolver)
        # planning makes no device table except for VALUES, which the
        # stage split refuses (an anonymous scan): keep those on the host
        phys = DefaultPhysicalPlanner("cpu").create_physical_plan(plan)
        dp = DistributedPlanner(self.target_partitions)
        stages, final = dp.plan_query_stages(job_id, phys)
        stage_dicts = []
        for s in stages:
            stage_dicts.append(
                {
                    "stage_id": s.stage_id,
                    "plan": serde.pplan_to_dict(s.plan),
                    "num_input_partitions": s.num_input_partitions,
                    "num_output_partitions": s.num_output_partitions,
                    "dependencies": s.dependencies,
                }
            )
        self.state.save_job(job_id, stage_dicts, final.stage_id)
        return job_id

    # ---- PollWork ----------------------------------------------------------
    def poll_work(
        self,
        executor_id: str,
        can_accept_task: bool = True,
        running: list[str] | None = None,
    ) -> dict | None:
        """Heartbeat + task pull (lib.rs:170). Returns a TaskDefinition dict
        {"job_id","stage_id","partition","plan"} or None.  `running` is the
        executor's in-flight task list (Ballista's PollWork carries
        task_statuses the same way) — any RUNNING task this executor owns
        but does not report is requeued (lost delivery / lost completion)."""
        self.state.heartbeat(executor_id)
        if running is not None:
            self.state.requeue_disowned_tasks(executor_id, running)
        if not can_accept_task:
            return None
        with self._lock:
            for job_id in self.state.running_jobs():
                a = self.state.assign_next_task(job_id, executor_id)
                if a is None:
                    continue
                stage = a["stage"]
                # resolve shuffle placeholders for this partition NOW: dep
                # stages are complete, their file locations deterministic
                try:
                    return self._resolve_task(job_id, a, stage)
                except Exception:
                    # roll the assignment back so the task is not stranded
                    # RUNNING on a live executor that never received it
                    self.state.unassign_task(
                        job_id, a["stage_id"], a["partition"]
                    )
                    raise
        return None

    def _resolve_task(self, job_id: str, a: dict, stage: dict) -> dict:
        writer = serde.pplan_from_dict(stage["plan"], None, self.work_dir)
        assert isinstance(writer, ShuffleWriterExec)
        stage_info = {
            d: {
                "num_input_partitions": self.state.stage(job_id, d)[
                    "num_input_partitions"
                ],
                "num_output_partitions": self.state.stage(job_id, d)[
                    "num_output_partitions"
                ],
            }
            for d in stage["dependencies"]
        }
        inner = remove_unresolved_shuffles(
            writer.plan, a["partition"], stage_info, self.work_dir, job_id
        )
        task_writer = ShuffleWriterExec(
            job_id,
            a["stage_id"],
            inner,
            writer.partition_exprs,
            writer.num_output_partitions,
            self.work_dir,
            a["partition"],
        )
        return {
            "job_id": job_id,
            "stage_id": a["stage_id"],
            "partition": a["partition"],
            "plan": serde.pplan_to_dict(task_writer),
        }

    # ---- task status -------------------------------------------------------
    def task_completed(self, executor_id, job_id, stage_id, partition, stats):
        self.state.complete_task(job_id, stage_id, partition, stats)

    def task_failed(self, executor_id, job_id, stage_id, partition, error):
        self.state.fail_task(job_id, stage_id, partition, error)

    # ---- GetJobStatus --------------------------------------------------------
    def get_job_status(self, job_id: str) -> dict:
        job = self.state.job(job_id)
        if job is None:
            raise PlanError(f"unknown job {job_id}")
        out = {"job_id": job_id, "status": job["status"], "error": job["error"]}
        if job["status"] == "COMPLETED":
            fsid = job["final_stage_id"]
            s = self.state.stage(job_id, fsid)
            out["final_paths"] = [
                ShuffleWriterExec.file_path(self.work_dir, job_id, fsid, i, 0)
                for i in range(s["num_input_partitions"])
            ]
            out["final_schema"] = serde.pplan_from_dict(
                s["plan"], None, self.work_dir
            ).schema()
        return out
