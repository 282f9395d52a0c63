"""Scheduler state: job/stage/task FSM over a pluggable KV store.

Copy of ``datafusion_tpu/distributed/state.py`` (host logic only).
Equivalent of Ballista's SchedulerState over ConfigBackendClient
(ballista/rust/scheduler/src/state/mod.rs:52-70): Ballista runs over etcd
(state/etcd.rs:33) or embedded sled (state/standalone.rs:32); here the
backends are an in-memory dict (standalone, one process) and a directory
of JSON files (several processes over a shared filesystem).

Task FSM as in Ballista: PENDING -> RUNNING -> COMPLETED | FAILED
(AwaitingDelivery/Running/Completed/Failed, state/mod.rs:279-398), with
stage-dependency readiness checked from completed shuffle locations and
executor liveness from heartbeat timestamps (state/mod.rs:121-133).
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..errors import InternalError

# ---------------------------------------------------------------------------
# KV backends
# ---------------------------------------------------------------------------


class InMemoryKV:
    """Standalone backend (Ballista's state/standalone.rs sled equivalent)."""

    def __init__(self):
        self._d: dict[str, str] = {}
        self._lock = threading.RLock()

    def get(self, key: str) -> str | None:
        with self._lock:
            return self._d.get(key)

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._d[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._d.pop(key, None)

    def keys(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self._d if k.startswith(prefix))

    def lock(self):
        return self._lock


class FileKV:
    """Shared-filesystem backend for multi-process clusters."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "%2F") + ".json")

    def get(self, key: str) -> str | None:
        try:
            with open(self._path(key)) as f:
                return f.read()
        except FileNotFoundError:
            return None

    def put(self, key: str, value: str) -> None:
        p = self._path(key)
        tmp = p + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, p)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self, prefix: str) -> list[str]:
        enc = prefix.replace("/", "%2F")
        out = []
        for fn in os.listdir(self.root):
            if fn.startswith(enc) and fn.endswith(".json"):
                out.append(fn[: -len(".json")].replace("%2F", "/"))
        return sorted(out)

    def lock(self):
        # cross-process callers coordinate through the scheduler process;
        # this lock only guards this process's threads
        return self._lock


# ---------------------------------------------------------------------------
# scheduler state
# ---------------------------------------------------------------------------

EXECUTOR_TIMEOUT_S = 30.0  # liveness window (get_alive_executors_metadata)


class SchedulerState:
    def __init__(self, kv=None, work_dir: str = ""):
        self.kv = kv if kv is not None else InMemoryKV()
        self.work_dir = work_dir

    # ---- helpers ---------------------------------------------------------
    def _get(self, key: str):
        raw = self.kv.get(key)
        return json.loads(raw) if raw is not None else None

    def _put(self, key: str, value) -> None:
        self.kv.put(key, json.dumps(value))

    # ---- executors -------------------------------------------------------
    def register_executor(self, executor_id: str, meta: dict | None = None):
        self._put(
            f"executors/{executor_id}",
            {"id": executor_id, "last_seen": time.time(), **(meta or {})},
        )

    def heartbeat(self, executor_id: str):
        m = self._get(f"executors/{executor_id}") or {"id": executor_id}
        m["last_seen"] = time.time()
        self._put(f"executors/{executor_id}", m)

    def alive_executors(self, window_s: float = EXECUTOR_TIMEOUT_S) -> list[str]:
        now = time.time()
        out = []
        for k in self.kv.keys("executors/"):
            m = self._get(k)
            if m and now - m["last_seen"] <= window_s:
                out.append(m["id"])
        return out

    # ---- jobs / stages / tasks --------------------------------------------
    def save_job(self, job_id: str, stages: list[dict], final_stage_id: int):
        """stages: [{stage_id, plan (serialized writer template),
        num_input_partitions, num_output_partitions, dependencies}]"""
        with self.kv.lock():
            self._put(
                f"jobs/{job_id}",
                {
                    "job_id": job_id,
                    "status": "RUNNING",
                    "final_stage_id": final_stage_id,
                    "stage_ids": [s["stage_id"] for s in stages],
                    "error": None,
                },
            )
            for s in stages:
                self._put(f"stages/{job_id}/{s['stage_id']}", s)
                for part in range(s["num_input_partitions"]):
                    self._put(
                        f"tasks/{job_id}/{s['stage_id']}/{part}",
                        {"status": "PENDING", "executor": None, "stats": None},
                    )

    def job(self, job_id: str) -> dict | None:
        return self._get(f"jobs/{job_id}")

    def stage(self, job_id: str, stage_id: int) -> dict:
        s = self._get(f"stages/{job_id}/{stage_id}")
        if s is None:
            raise InternalError(f"missing stage {job_id}/{stage_id}")
        return s

    def task(self, job_id: str, stage_id: int, part: int) -> dict:
        t = self._get(f"tasks/{job_id}/{stage_id}/{part}")
        if t is None:
            raise InternalError(f"missing task {job_id}/{stage_id}/{part}")
        return t

    def stage_complete(self, job_id: str, stage_id: int) -> bool:
        s = self.stage(job_id, stage_id)
        for part in range(s["num_input_partitions"]):
            if self.task(job_id, stage_id, part)["status"] != "COMPLETED":
                return False
        return True

    # ---- task FSM ---------------------------------------------------------
    def assign_next_task(self, job_id: str, executor_id: str) -> dict | None:
        """Pull-based assignment (assign_next_schedulable_task,
        state/mod.rs:279): first PENDING task whose stage deps completed."""
        with self.kv.lock():
            job = self.job(job_id)
            if job is None or job["status"] != "RUNNING":
                return None
            for sid in job["stage_ids"]:
                stage = self.stage(job_id, sid)
                if not all(
                    self.stage_complete(job_id, d) for d in stage["dependencies"]
                ):
                    continue
                for part in range(stage["num_input_partitions"]):
                    tkey = f"tasks/{job_id}/{sid}/{part}"
                    t = self._get(tkey)
                    if t["status"] == "PENDING":
                        t["status"] = "RUNNING"
                        t["executor"] = executor_id
                        t["started_at"] = time.time()
                        self._put(tkey, t)
                        return {
                            "job_id": job_id,
                            "stage_id": sid,
                            "partition": part,
                            "stage": stage,
                        }
        return None

    def running_jobs(self) -> list[str]:
        out = []
        for k in self.kv.keys("jobs/"):
            j = self._get(k)
            if j and j["status"] == "RUNNING":
                out.append(j["job_id"])
        return out

    def complete_task(self, job_id: str, stage_id: int, part: int, stats: list[dict]):
        with self.kv.lock():
            tkey = f"tasks/{job_id}/{stage_id}/{part}"
            t = self.task(job_id, stage_id, part)
            t["status"] = "COMPLETED"
            t["stats"] = stats
            self._put(tkey, t)
            self._sync_job_status(job_id)

    def fail_task(self, job_id: str, stage_id: int, part: int, error: str):
        with self.kv.lock():
            tkey = f"tasks/{job_id}/{stage_id}/{part}"
            t = self.task(job_id, stage_id, part)
            t["status"] = "FAILED"
            t["error"] = error
            self._put(tkey, t)
            job = self.job(job_id)
            job["status"] = "FAILED"
            job["error"] = error
            self._put(f"jobs/{job_id}", job)

    def _sync_job_status(self, job_id: str):
        """Reconcile task -> job status (synchronize_job_status_loop,
        state/mod.rs:409 — here run inline on every completion)."""
        job = self.job(job_id)
        if job["status"] != "RUNNING":
            return
        if all(self.stage_complete(job_id, sid) for sid in job["stage_ids"]):
            job["status"] = "COMPLETED"
            self._put(f"jobs/{job_id}", job)

    def requeue_lost_tasks(self, window_s: float = EXECUTOR_TIMEOUT_S):
        """Re-PENDING any RUNNING task owned by a dead executor — elastic
        recovery beyond Ballista (which fails the job)."""
        alive = set(self.alive_executors(window_s))
        with self.kv.lock():
            for job_id in self.running_jobs():
                job = self.job(job_id)
                for sid in job["stage_ids"]:
                    stage = self.stage(job_id, sid)
                    for part in range(stage["num_input_partitions"]):
                        tkey = f"tasks/{job_id}/{sid}/{part}"
                        t = self._get(tkey)
                        if t["status"] == "RUNNING" and t["executor"] not in alive:
                            t["status"] = "PENDING"
                            t["executor"] = None
                            self._put(tkey, t)

    def requeue_disowned_tasks(
        self, executor_id: str, running: list[str], grace_s: float = 2.0
    ):
        """Re-PENDING RUNNING tasks assigned to a LIVE executor that it does
        not report as in flight.  Closes the delivery-loss window: poll_work
        marks a task RUNNING *before* the plan is resolved and the RPC
        response reaches the executor; a serde error or dropped socket then
        strands the task RUNNING forever while the executor keeps
        heartbeating (so dead-executor requeue never fires).  The executor's
        poll loop is synchronous — any poll that omits a task it owns means
        that task was never delivered or its completion report was lost;
        either way re-running is safe (shuffle writes are atomic +
        deterministic).  `running` entries are "job/stage/part" strings."""
        mine = set(running)
        now = time.time()
        with self.kv.lock():
            for job_id in self.running_jobs():
                job = self.job(job_id)
                for sid in job["stage_ids"]:
                    stage = self.stage(job_id, sid)
                    for part in range(stage["num_input_partitions"]):
                        tkey = f"tasks/{job_id}/{sid}/{part}"
                        t = self._get(tkey)
                        if (
                            t["status"] == "RUNNING"
                            and t.get("executor") == executor_id
                            and f"{job_id}/{sid}/{part}" not in mine
                            and now - t.get("started_at", now) > grace_s
                        ):
                            t["status"] = "PENDING"
                            t["executor"] = None
                            self._put(tkey, t)

    def unassign_task(self, job_id: str, stage_id: int, part: int):
        """Roll an assignment back to PENDING (poll_work plan-resolution
        failed after assign_next_task already marked it RUNNING)."""
        with self.kv.lock():
            tkey = f"tasks/{job_id}/{stage_id}/{part}"
            t = self._get(tkey)
            if t is not None and t["status"] == "RUNNING":
                t["status"] = "PENDING"
                t["executor"] = None
                self._put(tkey, t)
