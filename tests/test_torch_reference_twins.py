"""Twins of reference tests that had none, with the reference's own bodies
(``torch_twins``), on the torch port on the CPU: the operators' compaction,
sort stability, top-k fetch and LIMIT/OFFSET (``test_operators.py``); the
semi/anti join pushdown (``test_semi_pushdown.py``); IN-subquery NULL
semantics and scalar subqueries kept apart in the plan cache
(``test_subquery_semantics.py``); the columnar round trip, capacity
padding, sorted dictionaries and date ingest (``test_columnar.py``); and
exactly full buffers (``test_capacity_edges.py``).

Left without a twin because they test a TPU mechanism the port does not
have by design:

* ``test_pallas.py::test_limb_sums_exact`` - K1's 8-bit limb sums, which a
  32-bit Mosaic kernel needs; the port's CUDA K1 adds int64 directly
  (``tests/test_torch_smalldomain.py`` holds it to the JAX package's K1);
* ``test_kernels.py::test_gather64_roundtrip`` - the int32 packing of a
  64-bit gather on the TPU; torch gathers int64 directly;
* ``test_join_fk.py``'s FK-specialized phase B (a fan-out of at most one,
  learned in the cold run, checks each probe row's candidates in place):
  the port expands candidates at the learned capacity instead, which took
  less kernel time on the card (``datafusion_tpu_torch/ops/join.py``); its
  rows are held to the JAX package's in ``tests/test_torch_joins.py``.
"""

from torch_twins import twin_tests

twin_tests(globals(), "test_operators.py", [
    "test_filter_compacts_rows", "test_sort_stability", "test_topk_fetch", "test_limit_skip",
])
twin_tests(globals(), "test_semi_pushdown.py", [
    "test_semi_sinks_below_inner_join", "test_pushed_semi_results_exact", "test_anti_pushes_too",
    "test_straddling_residual_stays_put",
])
twin_tests(globals(), "test_subquery_semantics.py", [
    "test_in_subquery_null_semantics", "test_scalar_subquery_bodies_not_conflated",
])
twin_tests(globals(), "test_columnar.py", [
    "test_from_pydict_roundtrip", "test_capacity_padding", "test_string_dict_sorted_and_merge",
    "test_date_ingest",
])
twin_tests(globals(), "test_capacity_edges.py", [
    "test_exactly_full_buffer_grouped_aggregates", "test_exactly_full_buffer_filter_keeps_all",
])
