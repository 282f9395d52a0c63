"""Twins of tests/test_sorted_ops.py on the torch port on the CPU: its 8
tests of the merge family, SortedAggregateExec, LastRowByUniqueKeyExec,
MergeJoinExec and the two sort rules, with the reference's own bodies
(``torch_twins``)."""

from torch_twins import twin_tests

twin_tests(globals(), "test_sorted_ops.py", [
    "test_merge_sort_two_runs", "test_merge_variants", "test_sorted_aggregate_matches_hash",
    "test_sorted_aggregate_with_nulls_in_keys", "test_last_row_by_unique_key",
    "test_merge_join_inner_and_left", "test_sorted_aggregate_rule_fires",
    "test_eliminate_redundant_sort",
])
