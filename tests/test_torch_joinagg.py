"""Twins of tests/test_joinagg.py on the torch port on the CPU, with the
reference's own bodies (``torch_twins``): the fused CrossJoinAgg plan, a
grouped non-equi aggregate, several tiles with the sides swapped, the bare
cross join without groups, an empty side, and the plan's round trip
through the distributed serde."""

from torch_twins import twin_tests

twin_tests(globals(), "test_joinagg.py", [
    "test_plan_uses_fused_node", "test_grouped_non_equi", "test_multi_tile_and_swap",
    "test_no_group_bare_cross", "test_empty_side", "test_serde_round_trip",
])
