"""Twins of tests/test_dataframe.py on the torch port on the CPU: 7 of its
8 tests with the reference's own bodies (``torch_twins``); the eighth
collects on a mesh, which comes with the multi-device slice, so its
single-device half is written here.  Also ``Table.from_pandas``, against
the JAX package's."""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pandas as pd

from datafusion_tpu.columnar.table import Table as JTable
import datafusion_tpu_torch as D

from torch_twins import twin_tests

twin_tests(globals(), "test_dataframe.py", [
    "test_select_filter_sort_limit", "test_aggregate", "test_join", "test_union_distinct_skip",
    "test_explain_and_schema", "test_select_columns", "test_bare_table_collect_keeps_all_columns",
])


def test_from_pandas_as_the_reference():
    """Ints, floats with NaN (a NULL) and -0.0, strings: the port's table
    equals the JAX package's, value for value."""
    df = pd.DataFrame({"i": np.array([3, 1, 2]), "f": [1.5, np.nan, -0.0], "s": ["x", "zz", "y"]})
    got = D.Table.from_pandas(df, device="cpu").to_pydict()
    want = JTable.from_pandas(df).to_pydict()
    assert got == want
    assert got["f"][1] is None and str(got["f"][2]) == "-0.0"


def test_collect_partitioned_without_a_mesh_is_one_partition():
    """The single-device half of test_dataframe.py's
    test_repartition_and_collect_partitioned."""
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_table("t", D.Table.from_pydict(
        {"k": list(range(100)), "g": [i % 5 for i in range(100)]}, device="cpu"))
    df = ctx.sql("SELECT k, g FROM t WHERE k >= 10")
    assert df.repartition(4).collect().to_pydict()["k"][:3] == [10, 11, 12]
    assert sorted(df.repartition(4, D.col("g")).collect().to_pydict()["k"]) == list(range(10, 100))
    parts = df.collect_partitioned()
    assert len(parts) == 1 and parts[0].nrows == 90
