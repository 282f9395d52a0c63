"""Twins of tests/test_sql.py: every one of its 37 tests, run on the torch
port on the CPU with the reference's own body and assertions
(``torch_twins``), the two window tests (``test_window_row_number``, a
fractional RANGE frame over a decimal key) included."""

from torch_twins import twin_tests

twin_tests(globals(), "test_sql.py", [
    "test_select_where", "test_arith_and_alias", "test_group_by", "test_having",
    "test_order_by_multiple", "test_limit_offset", "test_join_inner", "test_join_left",
    "test_case_expr", "test_in_list_and_between", "test_like", "test_distinct",
    "test_union_all", "test_union_dedup", "test_scalar_functions", "test_count_distinct",
    "test_avg_min_max", "test_subquery_scalar_uncorrelated", "test_subquery_in",
    "test_subquery_exists_correlated", "test_cte", "test_derived_table",
    "test_values_via_no_from", "test_cast", "test_null_semantics", "test_is_null",
    "test_window_row_number", "test_create_table_as", "test_create_and_drop_view",
    "test_information_schema", "test_explain", "test_like_is_case_sensitive",
    "test_or_common_conjunct_factoring", "test_decimal_float_literal_compare_rounds_to_scale",
    "test_decimal_ingest_with_none_and_fractional_range_frame",
    "test_string_functions_with_column_arguments", "test_decimal_precision_bound",
])
