"""Twins of tests/test_optimizer_stats.py on the torch port on the CPU:
its three tests that read no Parquet, with the reference's own bodies
(``torch_twins``); the Parquet statistics and pruning come with file
sources."""

from torch_twins import twin_tests

twin_tests(globals(), "test_optimizer_stats.py", [
    "test_count_star_from_statistics", "test_count_star_with_filter_not_rewritten",
    "test_build_probe_order_swaps_smaller_left",
])
