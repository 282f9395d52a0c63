"""Twins of tests/test_session_api.py on the torch port on the CPU: 9 of
its 11 tests with the reference's own bodies (``torch_twins``); the CSV
and Parquet writers come with file sources."""

from torch_twins import twin_tests

twin_tests(globals(), "test_session_api.py", [
    "test_information_schema_tables", "test_information_schema_columns", "test_variables",
    "test_show_variable", "test_create_table_as_and_drop", "test_views",
    "test_explain_verbose_captures_rules", "test_display_graphviz", "test_sysvar_double_at",
])
