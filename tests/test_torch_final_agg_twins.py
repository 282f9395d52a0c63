"""Twin of tests/test_operators.py::test_two_phase_agg_matches_single_phase
on the torch port on the CPU, with the reference's own body (``torch_twins``):
partial then final aggregation equals the single-phase aggregate."""

from torch_twins import twin_tests

twin_tests(globals(), "test_operators.py", ["test_two_phase_agg_matches_single_phase"])
