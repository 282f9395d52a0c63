"""Twins of tests/test_morsel.py: its seven tests that use no mesh, run on
the torch port on the CPU with the reference's own bodies and assertions
(``torch_twins``): host-resident tables streamed in morsels against the
device-resident engine, the morsel stage and the streamed join in the
plan, a single short morsel, the device-side outer rows of a streamed
join, and a host-right outer join with a residual filter."""

from torch_twins import twin_tests

twin_tests(globals(), "test_morsel.py", [
    "test_morsel_matches_device", "test_morsel_plan_engages",
    "test_morsel_single_morsel_degenerate", "test_morsel_join_matches_device",
    "test_morsel_join_plan_engages", "test_morsel_join_device_outer",
    "test_morsel_join_host_right_outer_with_filter",
])
