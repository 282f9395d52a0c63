"""A CPU twin of ``bench/sf_check.py``'s configuration: TPC-H with lineitem
AND orders host-resident, at SF 0.01 in morsels of 16,384 rows (lineitem
streams in four), for sf_check's nine queries (Q1, Q3, Q5, Q6, Q7, Q9,
Q10, Q12, Q18).  For each query, in the JAX package and the port:

* the plan streams the same tables in the same stages (MorselJoinStageExec,
  MorselStageExec) and materializes the same host scans
  (``expected.host_scans``; which side of Q12's join streams depends on
  the tables' sizes, so the SF10 plans are held to the JAX package's on
  the card, against the SF10 expected file's ``host_scans``);
* the port's rows equal the JAX package's and the port's own
  device-resident rows (floats rel 1e-12 of max(|want|, 1), everything
  else exact), in order where ``FULLY_ORDERED`` says so;
* a host table that a plan reads whole (Q12 here: orders, the build side
  of the join that streams lineitem) is uploaded once per context: a
  second collect reuses the same device table.
"""

import pytest

import datafusion_tpu as J
import datafusion_tpu_torch as D
from datafusion_tpu_torch.queries import FULLY_ORDERED, expected, run_tpch

from test_torch_morsel_tpch import _plans
from torch_parity import assert_rows_equal, port_table

SF_CHECK_QUERIES = (1, 3, 5, 6, 7, 9, 10, 12, 18)  # bench/sf_check.py's set
HOST_TABLES = ("lineitem", "orders")
MORSEL_ROWS = 1 << 14


@pytest.fixture(scope="module")
def sf_check_host():
    """(JAX context, port context, port device-resident context): the TPC-H
    tables at SF 0.01, lineitem and orders host-resident."""
    from torch_tpch import jax_tables

    jctx, pctx, dctx = J.ExecutionContext(), D.ExecutionContext(device="cpu"), D.ExecutionContext(device="cpu")
    for name, jt in jax_tables().items():
        pt = port_table(jt)
        dctx.register_table(name, pt)
        if name in HOST_TABLES:
            jctx.register_host_table(name, jt, morsel_rows=MORSEL_ROWS)
            pctx.register_host_table(name, pt, morsel_rows=MORSEL_ROWS)
        else:
            jctx.register_table(name, jt)
            pctx.register_table(name, pt)
    return jctx, pctx, dctx


def _sorted(d: dict) -> dict:
    key = lambda r: tuple((v is None, v) for v in r)  # noqa: E731
    return dict(zip(d, map(list, zip(*sorted(zip(*d.values()), key=key))))) if d else d


def test_lineitem_streams_in_several_morsels(sf_check_host):
    _, pctx, _ = sf_check_host
    assert pctx._resolve_table("lineitem").host.num_morsels >= 4


@pytest.mark.parametrize("q", SF_CHECK_QUERIES)
def test_sf_check_query_as_the_reference(sf_check_host, q):
    jctx, pctx, dctx = sf_check_host
    scans = expected.host_scans(_plans(pctx, q))
    assert scans == expected.host_scans(_plans(jctx, q))
    assert any(kind != "materialized" for kind, _ in scans), "no host-resident table streams"

    rows = run_tpch(pctx, q)
    floats = [n for n, c in zip(rows.names, rows.columns) if c.dtype.is_float]
    got_rows = rows.to_pydict()
    ref, dev = run_tpch(jctx, q).to_pydict(), run_tpch(dctx, q).to_pydict()
    if q not in FULLY_ORDERED:
        got_rows, ref, dev = _sorted(got_rows), _sorted(ref), _sorted(dev)
    assert_rows_equal(got_rows, ref, floats)
    assert_rows_equal(got_rows, dev, floats)

    # a host table read whole is uploaded once per context, not per collect
    mats = {t: pctx._resolve_table(t).host._materialized for kind, t in scans if kind == "materialized"}
    assert all(m is not None for m in mats.values()), mats
    again = run_tpch(pctx, q).to_pydict()
    assert_rows_equal(_sorted(again) if q not in FULLY_ORDERED else again, got_rows, floats)
    for t, m in mats.items():
        assert pctx._resolve_table(t).host._materialized is m, t
