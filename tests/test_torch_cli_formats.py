"""The torch port's CLI prints what the JAX package's prints, byte for
byte, on the CPU: every print format (table, csv, tsv, json, ndjson), with
and without the row-count line, for queries over integers, floats,
decimals, dates, booleans, strings and NULLs run in both engines on the
same buffers."""

import jax

jax.config.update("jax_platforms", "cpu")

import re

import numpy as np
import pytest

import datafusion_tpu as J
from datafusion_tpu import cli as jcli
from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.types.dtypes import DATE32 as JDATE32, decimal as jdecimal

import datafusion_tpu_torch as D
from datafusion_tpu_torch import cli as pcli

from torch_parity import port_table

QUERIES = [
    "SELECT k, sum(v) AS s, count(*) AS c, avg(f) AS a FROM t GROUP BY k ORDER BY k",
    "SELECT k, d, p, b, f FROM t ORDER BY v",
    "SELECT 1 AS one, 'x' AS s, NULL AS z",
]


def contexts():
    data = {
        "k": ["b", "a", None, "b", "c", "a"],
        "v": [6, 2, 3, 4, 5, 1],
        "f": [1.5, None, -0.25, 1e20, 3.0, 2.0 / 3.0],
        "d": ["1998-09-02", "1970-01-01", None, "2001-02-03", "1992-12-31", "1995-06-17"],
        "p": [1.25, 100.0, None, -3.5, 0.01, 7.0],
        "b": [True, False, None, True, False, True],
    }
    data["d"] = np.array(data["d"], dtype="datetime64[D]")
    jt = JTable.from_pydict(data, dtypes={"d": JDATE32, "p": jdecimal(15, 2)})
    jctx, pctx = J.ExecutionContext(), D.ExecutionContext(device="cpu")
    jctx.register_table("t", jt)
    pctx.register_table("t", port_table(jt))
    return jctx, pctx


@pytest.mark.parametrize("quiet", [True, False])
@pytest.mark.parametrize("fmt", ["table", "csv", "tsv", "json", "ndjson"])
def test_output_equals_the_jax_package(fmt, quiet, capsys):
    jctx, pctx = contexts()
    outs = []
    for cli, ctx in ((jcli, jctx), (pcli, pctx)):
        for q in QUERIES:
            cli.run_statement(ctx, q, fmt, quiet)
        # the timing in the row-count line differs from run to run
        outs.append(re.sub(r"Query took \d+\.\d+ seconds", "Query took T seconds",
                           capsys.readouterr().out))
    assert outs[1] == outs[0]
    assert outs[0].count("rows in set") == (0 if quiet else len(QUERIES))
