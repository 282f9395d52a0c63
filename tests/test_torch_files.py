"""File sources and Arrow on the torch port on the CPU: twins, with the
reference's own bodies (``torch_twins``), of tests/test_optimizer_stats.py's
five Parquet tests (MIN/MAX folded from footer statistics, row-group
pruning and its operators), tests/test_session_api.py's CSV and Parquet
writers, and tests/test_columnar.py::test_arrow_roundtrip.  The JAX
package runs the same tests from the reference's files."""

from torch_twins import twin_tests

twin_tests(globals(), "test_optimizer_stats.py", [
    "test_min_max_from_parquet_stats", "test_parquet_row_group_pruning",
    "test_pruning_string_and_inlist", "test_pruning_unknown_stats_keeps_all",
    "test_pruning_extended_operators",
])
twin_tests(globals(), "test_session_api.py", ["test_write_csv_roundtrip", "test_write_parquet_roundtrip"])
twin_tests(globals(), "test_columnar.py", ["test_arrow_roundtrip"])
