"""Executor: pull tasks, run shuffle-writer stages on the local device.

Port of ``datafusion_tpu/distributed/executor.py``.  Equivalent of
Ballista's executor poll loop (ballista/rust/executor/src/
execution_loop.rs:39): poll the scheduler with free-slot count, decode the
TaskDefinition's physical plan, run ShuffleWriterExec for the assigned
input partition, report status.  The Flight service
(executor/src/flight_service.rs:55) is replaced by the shared-filesystem
spill files (shuffle_io.py): a completed stage's output partitions are
durable and never re-run.

Each executor runs on its ``device`` (None: the card; a process asked for
the card where there is none raises, it never carries on on the CPU):
stage subtrees run unfused through the single-device operators, or SPMD
over a mesh of ``mesh_devices`` logical shards on it.

Several executors in one process share the card.  Each runs its tasks in
its own thread; speculation state and the whole-query build state are
per thread, and stage plans run unfused and never capture a CUDA graph.
Two things are process-wide and must not meet a running executor: a
CUDA graph capture in torch's default (global) capture mode fails if
another thread waits for the device meanwhile, and
``torch.cuda.set_sync_debug_mode``, which the whole-query check sets,
applies to every thread.  So an ``ExecutionContext.collect`` that checks
or captures a plan in the same process must not run while a standalone
cluster's executors run tasks.
"""

from __future__ import annotations

import threading
import time
import traceback

from ..device import resolve_device
from . import serde
from .exchange import ShuffleWriterExec, TableStore, add_times
from .planner import bind_scan_partition


class Executor:
    def __init__(
        self,
        executor_id: str,
        scheduler,
        store: TableStore,
        poll_interval_s: float = 0.01,
        mesh_devices: int | None = None,
        device=None,
    ):
        self.executor_id = executor_id
        self.scheduler = scheduler
        self.store = store
        self.poll_interval_s = poll_interval_s
        self.mesh_devices = mesh_devices
        self.device = resolve_device(device)
        self._mesh = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def mesh(self):
        """The executor's mesh of ``mesh_devices`` logical shards on its
        device (``parallel.mesh.make_mesh``), made on first use; None keeps
        the single-device operators."""
        if self.mesh_devices and self._mesh is None:
            from ..parallel.mesh import make_mesh

            self._mesh = make_mesh(self.mesh_devices, device=self.device)
        return self._mesh

    # ---- lifecycle ---------------------------------------------------------
    def start(self):
        self.scheduler.state.register_executor(self.executor_id)
        self._thread = threading.Thread(target=self.poll_loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _sleep(self):
        time.sleep(self.poll_interval_s)
        add_times(poll_sleep_s=self.poll_interval_s)

    # ---- poll loop (execution_loop.rs:39) -----------------------------------
    def poll_loop(self):
        while not self._stop.is_set():
            try:
                # running=[] (the loop is synchronous: nothing is in flight
                # at poll time) lets the scheduler requeue any task it still
                # believes we own: delivery or completion report was lost
                task = self.scheduler.poll_work(self.executor_id, True, running=[])
            except TypeError:
                # older scheduler without the `running` lease parameter
                try:
                    task = self.scheduler.poll_work(self.executor_id, True)
                except Exception:
                    self._sleep()
                    continue
            except Exception:
                self._sleep()
                continue
            if task is None:
                self._sleep()
                continue
            self.run_task(task)

    def run_task(self, task: dict):
        job_id, stage_id, part = task["job_id"], task["stage_id"], task["partition"]
        try:
            plan = serde.pplan_from_dict(
                task["plan"], self.store, self.scheduler.work_dir, self.device
            )
            assert isinstance(plan, ShuffleWriterExec)
            bind_scan_partition(plan, part, self.store)
            from ..ops import kernels as K

            with K.spec_window() as w:
                stats = plan.execute_shuffle_write(mesh=self.mesh)
            if w.overflowed():  # fan-out beyond speculative sizing: redo exactly
                with K.spec_exact():
                    stats = plan.execute_shuffle_write(mesh=self.mesh)
            self.scheduler.task_completed(
                self.executor_id, job_id, stage_id, part, stats
            )
        except Exception as e:  # report FailedTask (execution_loop.rs:170)
            self.scheduler.task_failed(
                self.executor_id,
                job_id,
                stage_id,
                part,
                f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=5)}",
            )
