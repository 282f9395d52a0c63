"""Write the expected rows of ``bench/sf_check.py``'s nine TPC-H queries at
SF10, seed 7, from the JAX package with lineitem and orders host-resident,
checked against the pandas oracle:

    JAX_PLATFORMS=cpu python tests/torch_expected_sf10.py --write [--queries 1,6] [--out PATH]

Generates ``tpchdata.generate_tpch(10.0, 7)`` and loads it into the JAX
package as ``bench/sf_check.py`` does (``bench/tpch.py::load_engine_tables``
with ``host_tables=("lineitem", "orders")``: those two tables stay in host
memory and stream in morsels of 2^20 rows, the other six are typed as
``tests/torch_tpch.py::jax_tables`` types them).  It runs the port's texts
of Q1, Q3, Q5, Q6, Q7, Q9, Q10, Q12 and Q18 through ``run_tpch`` and holds
each result to ``bench/golden_pandas.py::pandas_query`` with
``bench/golden.py::compare_results``, as ``tests/torch_expected_sf1.py``
does at SF1.  Where the two disagree it asks sqlite which is right, prints
the three verdicts and writes nothing for that query.

The file records, for all nine queries, which stages of the JAX package's
plan stream which host table and which host scans it reads whole
(``expected.host_scans``).  Each checked query is written to
``tests/data/torch_tpch_sf10_seed7.json.gz`` at once, beside the entries
the file already holds for the same SF, seed and tables, so the queries
can be run in pieces (``--queries``), each piece its own process, and a
cut run loses only its unwritten queries.

Slow and large on eight CPU cores: generating takes about 40 s, the
digests 30 s, loading into the JAX package 50 s; pandas 45-90 s per
query; the JAX package 2-260 s per query and 420-460 s for Q7, which
alone holds about 33 GB beyond the engine's tables (about 10 GB).  The
process peaks near 30 GB for Q6 and Q12, so run Q7 in a piece of its own
on a host with 64 GB.
"""

from __future__ import annotations

import argparse
import gc
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXPECTED = ROOT / "tests" / "data" / "torch_tpch_sf10_seed7.json.gz"
SF, SEED = 10.0, 7
QUERIES = (1, 3, 5, 6, 7, 9, 10, 12, 18)
HOST_TABLES = ("lineitem", "orders")
MORSEL_ROWS = 1 << 20


_ARRAYS = {}  # the generated arrays, for the forked pandas children


def _pandas_oracle(q: int) -> tuple:
    """(pandas' rows of query q, seconds), in a child process."""
    from bench.golden_pandas import pandas_query

    t0 = time.perf_counter()
    return pandas_query(_ARRAYS["data"], q), time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="write each checked query to the file")
    ap.add_argument("--out", default=str(EXPECTED), help="where to write it")
    ap.add_argument("--queries", default=",".join(map(str, QUERIES)),
                    help="comma-separated queries to run (default: the nine)")
    args = ap.parse_args(argv)
    todo = [int(q) for q in args.queries.split(",") if q]
    if not set(todo) <= set(QUERIES):
        ap.error(f"--queries must be among {QUERIES}")

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np

    import datafusion_tpu as J
    from bench.golden import compare_results, load_sqlite, run_golden, table_to_rows
    from bench.tpch import load_engine_tables
    from datafusion_tpu_torch import tpchdata
    from datafusion_tpu_torch.queries import FULLY_ORDERED, ORDER_SPECS, get_query_sql, run_tpch
    from datafusion_tpu_torch.queries import expected
    from torch_expected_sf1 import column_kinds

    t0 = time.perf_counter()
    data = tpchdata.generate_tpch(SF, SEED)
    gen_s = time.perf_counter() - t0
    tables = expected.table_digest(data)
    digest_s = time.perf_counter() - t0 - gen_s
    doc = {"sf": SF, "seed": SEED, "tables": tables, "queries": {}, "host_tables": list(HOST_TABLES),
           "morsel_rows": MORSEL_ROWS,
           "versions": {"numpy": np.__version__, "datafusion_tpu": J.__version__, "jax": jax.__version__}}
    out = Path(args.out)
    if args.write and out.exists():
        prev = expected.load(out)
        if (prev["sf"], prev["seed"], prev["tables"]) == (SF, SEED, tables):
            doc["queries"] = prev["queries"]
            print(f"resuming {out}: queries {sorted(map(int, prev['queries']))} kept", flush=True)
    # pandas first, each query in a forked child that sees the generated
    # arrays and gives its memory back when it exits; then the JAX package
    # with the arrays freed (its host tables keep what they need).  The
    # memory a process takes is not given back while it lives, and the JAX
    # package's Q7 alone takes about 33 GB beyond its tables
    _ARRAYS["data"] = data
    oracles = {}
    for q in todo:
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("fork")) as pool:
            oracles[q] = pool.submit(_pandas_oracle, q).result()
    _ARRAYS.clear()
    t0 = time.perf_counter()
    ctx = J.ExecutionContext()
    load_engine_tables(ctx, data, host_tables=HOST_TABLES)
    del data
    gc.collect()
    print(f"SF{SF:g} seed {SEED}: generated in {gen_s:.1f} s, digested in {digest_s:.1f} s, pandas "
          f"{sum(s for _, s in oracles.values()):.1f} s, loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    # which stages stream which host table, and which host scans are read
    # whole, in the JAX package's plan of each of the nine queries
    doc["host_scans"] = {}
    for q in QUERIES:
        plan = ctx.create_physical_plan(ctx.optimize(ctx.sql(get_query_sql(q)).logical_plan()))
        doc["host_scans"][str(q)] = expected.host_scans(plan)
    print(f"host scans of the JAX package's plans: {doc['host_scans']}", flush=True)
    if args.write:
        expected.write(out, doc)
    faults, conn = [], None
    for q in todo:
        t0 = time.perf_counter()
        result = run_tpch(ctx, q)
        secs = time.perf_counter() - t0
        engine = table_to_rows(result)
        oracle, psecs = oracles.pop(q)
        ordered, spec = q in FULLY_ORDERED, ORDER_SPECS.get(q)
        err = compare_results(engine, oracle, ordered=ordered, order_spec=spec)
        if err is not None:
            faults.append(q)
            print(f"Q{q}: the JAX package and pandas differ: {err}", flush=True)
            if conn is None:
                conn = load_sqlite(tpchdata.generate_tpch(SF, SEED))
            sq = run_golden(conn, get_query_sql(q))
            print(f"Q{q}: sqlite vs the JAX package: "
                  f"{compare_results(engine, sq, ordered=ordered, order_spec=spec)}; sqlite vs pandas: "
                  f"{compare_results(oracle, sq, ordered=ordered, order_spec=spec)}", flush=True)
            continue
        rows = list(zip(*result.to_pydict().values()))
        doc["queries"][str(q)] = expected.entry(get_query_sql(q), rows, column_kinds(result), ordered, spec)
        print(f"Q{q}: {len(rows)} rows, equal to pandas; the JAX package {secs:.1f} s, pandas "
              f"{psecs:.1f} s", flush=True)
        if args.write:
            expected.write(out, doc)
            print(f"wrote {out}: {out.stat().st_size} bytes, queries "
                  f"{sorted(map(int, doc['queries']))}", flush=True)
        del result, engine, oracle, rows
        gc.collect()
    if faults:
        print(f"not written: queries {faults} differ from pandas", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
