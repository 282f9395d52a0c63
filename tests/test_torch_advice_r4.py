"""Twins of tests/test_advice_r4.py on the torch port on the CPU: its
learned-capacity, vrange-narrowing, wide-key and stage-cache tests run
with the reference's own bodies (``torch_twins``); the int64 candidate
total is the same check on torch tensors.  The per-thread segment-position
memo test has no twin: the port finds a grouping's segments once per
grouping (``ops/kernels.py::segments``) and keeps no memo."""

import torch

from datafusion_tpu_torch.ops import kernels as PK

from torch_twins import twin_tests

twin_tests(globals(), "test_advice_r4.py", [
    "test_learned_final_cap_overflow_reruns_exactly", "test_vrange_narrowing_keyed_in_stage_cache",
    "test_wide_int64_join_keys_match_exactly", "test_stage_cache_reads_current_table_data",
])


def test_candidate_stats_accumulates_int64_torch():
    counts = torch.full((3,), 1 << 30, dtype=torch.int32)  # total 3*2^30 > 2^31
    stats = PK.candidate_stats(counts)
    assert int(stats[0]) == 3 << 30
    assert int(stats[1]) == 1 << 30
