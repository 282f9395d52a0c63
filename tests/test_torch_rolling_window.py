"""Twins of tests/test_rolling_window.py on the torch port on the CPU: its
8 tests of ROLLING_WINDOW (cumulative and windowed sums, PARTITION BY,
count/avg/min, EVERY 2, GROUP BY DIMENSION, two windows of one aggregate,
the planner's errors), with the reference's own bodies (``torch_twins``)."""

from torch_twins import twin_tests

twin_tests(globals(), "test_rolling_window.py", [
    "test_cumulative_rolling_sum", "test_windowed_partitioned", "test_rolling_count_and_avg",
    "test_rolling_min_cumulative", "test_grid_every_two", "test_group_by_dimension_plain_agg",
    "test_two_different_windows_not_deduped", "test_errors",
])
