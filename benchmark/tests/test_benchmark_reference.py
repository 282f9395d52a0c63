"""The plain reference against the port on the CPU at SF 0.05, for every
query of both mixes; the comparison refusing a planted wrong row; and the
control (the reference in float32, in the port's place) failing it."""

import datetime
import json
from pathlib import Path

import pytest
import torch

from benchmark import ingest, reference, tpchgen
from benchmark.control import readings as control_readings
from benchmark.compare import compare

HERE = Path(__file__).resolve().parents[1]
QUERIES = sorted({q for m in ("nine", "nine_spec")
                  for q in json.loads((HERE / "mixes" / f"{m}.json").read_text())["queries"]})
CPU = torch.device("cpu")
CONFIG = json.loads((HERE / "configs" / "tpch_sf10_dev.json").read_text())
FLOAT_LIMIT = CONFIG["limits"]["float_rel_err"]


@pytest.fixture(scope="module")
def data():
    return tpchgen.generate(0.05, 20260417, CPU)


@pytest.fixture(scope="module")
def port_rows(data):
    """Each query's rows from the port, twice: all tables on the device
    (here the CPU) and lineitem and orders host-resident in small morsels."""
    dev = ingest.context(data, CONFIG, CPU)
    host = ingest.context(data, {"host_tables": ["lineitem", "orders"], "morsel_rows": 8192}, CPU)
    text = {q: (HERE / "queries" / f"{q}.sql").read_text() for q in QUERIES}
    return {q: (dev.sql(text[q]).collect().to_pydict(), host.sql(text[q]).collect().to_pydict())
            for q in QUERIES}


@pytest.fixture(scope="module")
def want(data):
    x = reference.Inputs(data, CPU)
    return {q: reference.run(q, x) for q in QUERIES}


@pytest.fixture(scope="module")
def control(data):
    x = reference.Inputs(data, CPU, money="float32")
    return {q: reference.run(q, x) for q in QUERIES}


@pytest.mark.parametrize("query", QUERIES)
def test_port_equals_reference(query, port_rows, want):
    assert want[query].values and len(want[query].values[0]) > 0, "a query with no rows proves little"
    for rows in port_rows[query]:
        v = compare(rows, want[query])
        assert v.ok, v.reason
        assert v.float_err <= FLOAT_LIMIT


def _altered(rows: dict) -> dict:
    """``rows`` with one value of the last column changed where a query
    produces it: a string gains a letter, a number grows, a date moves."""
    out = {k: list(v) for k, v in rows.items()}
    col = list(out)[-1]
    v = out[col][-1]
    if isinstance(v, str):
        out[col][-1] = v + "x"
    elif isinstance(v, datetime.date):
        out[col][-1] = v + datetime.timedelta(days=1)
    elif isinstance(v, float) and v != int(v):
        out[col][-1] = v * (1 + 1e-6)
    else:
        out[col][-1] = v + 1
    return out


@pytest.mark.parametrize("query", QUERIES)
def test_planted_faults_fail(query, port_rows, want):
    rows = port_rows[query][0]
    bad = _altered(rows)
    v = compare(bad, want[query])
    assert not v.ok or v.float_err > FLOAT_LIMIT
    dropped = {k: v[:-1] for k, v in rows.items()}
    assert not compare(dropped, want[query]).ok
    if len(next(iter(rows.values()))) > 1 and want[query].order_by:
        flipped = {k: v[::-1] for k, v in rows.items()}
        if flipped != rows:
            assert not compare(flipped, want[query]).ok


def test_control_fails(control, want):
    """In the port's place, the float32 reference fails the exact columns
    of every query that returns a decimal (all but Q12, which counts), and
    Q1's means lie past the float limit."""
    for q in QUERIES:
        v = compare(control[q].answer(), want[q])
        money = any(k.startswith("decimal") for _, k in want[q].columns)
        assert v.ok != money, q
    assert compare(control["q1"].answer(), want["q1"]).float_err > FLOAT_LIMIT


@pytest.mark.parametrize("query", QUERIES)
def test_reference_answers_its_own_check(query, want):
    """The exact reference in the port's place passes: its answer is in
    ORDER BY order and cut to the LIMIT."""
    v = compare(want[query].answer(), want[query])
    assert v.ok and v.float_err == 0.0, v.reason


@pytest.mark.parametrize("workload", ["sf10_dev.nine", "sf10_host.nine", "sf10_dev.nine_spec"])
def test_control_through_the_runs_check(workload):
    """The chip's control (``benchmark.control``) at a test's size: the
    run's own check refuses it on both of its numbers."""
    r = control_readings(workload, 20260417, CPU, sf=0.05)
    assert r["wrong_results"] == 8  # the nine less Q12, which sums no money
    assert r["float_rel_err"] > FLOAT_LIMIT
