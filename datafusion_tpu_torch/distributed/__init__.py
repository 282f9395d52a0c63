"""Distributed query execution: the Ballista-equivalent layer.

Port of ``datafusion_tpu/distributed``.  Components (Ballista's crates in
brackets):
  serde        plan <-> dict wire contract     (ballista.proto + serde/)
  planner      stage-DAG splitting             (scheduler/src/planner.rs)
  exchange     shuffle writer/reader/scan ops  (core/src/execution_plans/)
  shuffle_io   at-rest columnar spill format   (Arrow IPC shuffle files)
  state        job/stage/task FSM over KV      (scheduler/src/state/)
  scheduler    ExecuteQuery / PollWork service (scheduler/src/lib.rs)
  executor     poll loop running stage tasks   (executor/src/execution_loop.rs)
  context      client facade + standalone mode (client/src/context.rs)
  rpc          JSON-over-TCP control plane for several processes

The exchange inside one executor's mesh stays on the ``parallel``
package's collectives; this layer is the host-level control plane and the
spill-file data plane between executors.
"""

from .context import DistributedContext, DistributedDataFrame
from .exchange import (
    DistScanExec,
    ShuffleReaderExec,
    ShuffleWriterExec,
    TableStore,
    UnresolvedShuffleExec,
)
from .executor import Executor
from .planner import DistributedPlanner, QueryStage, remove_unresolved_shuffles
from .scheduler import Scheduler
from .state import FileKV, InMemoryKV, SchedulerState

__all__ = [
    "DistributedContext",
    "DistributedDataFrame",
    "DistributedPlanner",
    "DistScanExec",
    "Executor",
    "FileKV",
    "InMemoryKV",
    "QueryStage",
    "Scheduler",
    "SchedulerState",
    "ShuffleReaderExec",
    "ShuffleWriterExec",
    "TableStore",
    "UnresolvedShuffleExec",
    "remove_unresolved_shuffles",
]
