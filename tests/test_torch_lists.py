"""Fixed-size list columns (``array(...)``, datafusion_tpu_torch/columnar/
column.py) on the torch port on the CPU: the twin of
tests/test_functions.py::test_array_constructor_numeric_and_null with the
reference's own body (``torch_twins``), and list columns through a
projection, a filter, a sort, a UNION ALL and the morsels of a host table
into ``to_pydict()``.  Against the JAX package: test_torch_functions.py
(test_array_matches_jax)."""

import datafusion_tpu_torch as D
from torch_twins import twin_tests

twin_tests(globals(), "test_functions.py", ["test_array_constructor_numeric_and_null"])

DATA = {"a": [1, 2, 3, 4], "b": [4.0, None, 6.0, 7.5], "s": ["x", None, "z", "x"]}


def test_list_through_projection_filter_and_union():
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table("t", D.Table.from_pydict(DATA, device="cpu"))
    got = ctx.sql(
        "SELECT a, array(b, a) AS l, array(s, 'w') AS ls FROM t WHERE b > 5 OR b IS NULL ORDER BY a"
    ).collect().to_pydict()
    assert got == {"a": [2, 3, 4], "l": [[None, 2.0], [6.0, 3.0], [7.5, 4.0]],
                   "ls": [[None, "w"], ["z", "w"], ["x", "w"]]}
    u = ctx.sql("SELECT array(a, a * 2) AS l FROM t WHERE a < 3 UNION ALL "
                "SELECT array(a, a) FROM t WHERE a > 3").collect().to_pydict()
    assert u == {"l": [[1, 2], [2, 4], [4, 4]]}


def test_list_through_morsels():
    ctx = D.ExecutionContext(device="cpu")
    data = {"a": list(range(3000)), "b": [float(i) if i % 7 else None for i in range(3000)]}
    ctx.register_host_table("t", D.Table.from_pydict(data, device="cpu"), morsel_rows=1024)
    got = ctx.sql("SELECT array(a, b) AS l FROM t WHERE a % 1000 = 7").collect().to_pydict()
    assert got == {"l": [[7.0, None], [1007.0, 1007.0], [2007.0, 2007.0]]}
