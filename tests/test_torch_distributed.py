"""Twins of tests/test_distributed.py on the torch port on the CPU: the 11
tests that do not read the TPC-H query text of ``bench.tpch`` (the stage
splits, broadcast, local top-K, sort coalescing, the standalone
aggregate, string-key co-partitioning, heartbeat, failed task, lost
executor and distinct aggregates) run the reference's own bodies and
assertions on the port's distributed runtime (``torch_twins``).  The
TPC-H tests have the port's own text in test_torch_distributed_tpch.py."""

import jax

jax.config.update("jax_platforms", "cpu")

from torch_mesh import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_twins import twin_tests

twin_tests(globals(), "test_distributed.py", [
    "test_stage_split_aggregate", "test_stage_split_join", "test_broadcast_join_single_partition_build",
    "test_local_topk_pushdown", "test_stage_split_sort_coalesces", "test_standalone_simple_aggregate",
    "test_standalone_join_string_keys_copartition", "test_executor_heartbeat_liveness",
    "test_failed_task_fails_job", "test_lost_executor_requeues_tasks",
    "test_distributed_distinct_aggregates",
])
