"""Twins of tests/test_parallel.py on the torch port on the CPU: all 21 of
its tests, with their parametrized cases, run the reference's own bodies
and assertions on the port's mesh (``torch_twins``): 8 logical shards on
the CPU where the JAX package has 8 virtual devices."""

import jax

jax.config.update("jax_platforms", "cpu")

from torch_mesh import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_twins import twin_tests

twin_tests(globals(), "test_parallel.py", [
    "test_shard_roundtrip", "test_dist_filter_project", "test_dist_aggregate_matches_single_device",
    "test_dist_aggregate_no_group", "test_dist_join_skewed_fanout_retry",
    "test_dist_join_matches_single_device", "test_dist_sort_total_order", "test_dist_sort_with_nulls",
    "test_dist_join_all_types_match_single_device", "test_dist_join_residual_filter",
    "test_dist_join_skew_aware", "test_dist_window_matches_local", "test_dist_limit_offset_matches_local",
    "test_dist_distinct_aggregate_matches_local", "test_dist_global_distinct_mesh_native",
    "test_dist_window_global_order_mesh_native", "test_dist_sort_sql_nulls_desc_strings",
    "test_dist_join_broadcast", "test_join_skew_auto_selected_end_to_end",
    "test_mesh_explain_analyze_reports_exchange_metrics", "test_dist_union_shard_wise",
])
