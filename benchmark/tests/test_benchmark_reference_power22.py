"""The plain reference of the 13 queries that ``power22`` adds to the nine
(semi, anti and outer joins, decorrelated subqueries, COUNT DISTINCT)
against the port on the CPU at SF 0.05, where every one of them returns
rows; the comparison refusing a planted fault in each; the control (the
reference in float32, in the port's place) failing every query that
returns money; and whole runs of the two ``power22`` cells."""

import datetime
import json
from pathlib import Path

import pytest
import torch

from benchmark import control, ingest, reference, run, tpchgen
from benchmark.compare import compare

HERE = Path(__file__).resolve().parents[1]
MIX = json.loads((HERE / "mixes" / "power22.json").read_text())["queries"]
NINE = {q for m in ("nine", "nine_spec")
        for q in json.loads((HERE / "mixes" / f"{m}.json").read_text())["queries"]}
QUERIES = sorted(set(MIX) - NINE, key=lambda q: int(q[1:]))
CELLS = ["sf1_dev.power22", "sf10_dev.power22"]
CPU = torch.device("cpu")
SF, SEED = 0.05, 20260417
CONFIG = json.loads((HERE / "configs" / "tpch_sf1_dev.json").read_text())
FLOAT_LIMIT = CONFIG["limits"]["float_rel_err"]


def _money(result) -> bool:
    return any(k.startswith("decimal") for _, k in result.columns)


@pytest.fixture(scope="module")
def data():
    return tpchgen.generate(SF, SEED, CPU)


@pytest.fixture(scope="module")
def port_rows(data):
    """Each query's rows from the port, twice: all tables on the device
    (here the CPU) and lineitem and orders host-resident in small morsels."""
    dev = ingest.context(data, CONFIG, CPU)
    host = ingest.context(data, {"host_tables": ["lineitem", "orders"], "morsel_rows": 8192}, CPU)
    text = {q: run.query_text(q) for q in QUERIES}
    return {q: (dev.sql(text[q]).collect().to_pydict(), host.sql(text[q]).collect().to_pydict())
            for q in QUERIES}


@pytest.fixture(scope="module")
def want(data):
    x = reference.Inputs(data, CPU)
    return {q: reference.run(q, x) for q in QUERIES}


@pytest.fixture(scope="module")
def control_rows(data):
    x = reference.Inputs(data, CPU, money="float32")
    return {q: reference.run(q, x) for q in QUERIES}


def test_the_mix_is_tpch_22():
    assert len(MIX) == 22 and len(QUERIES) == 13 and set(MIX) & NINE == NINE - {"q3", "q10", "q18"}
    assert QUERIES == ["q2", "q4", "q8", "q11", "q13", "q14", "q15", "q16", "q17", "q19", "q20", "q21",
                       "q22"]


@pytest.mark.parametrize("query", QUERIES)
def test_port_equals_reference(query, port_rows, want):
    w = want[query]
    assert w.values and len(w.values[0]) > 0, "a query with no rows proves little"
    # a one-row aggregate over no qualifying line would be NULL or 0
    assert all(len(v) > 1 or v[0] != 0 for v in w.values), "an empty aggregate proves little"
    for rows in port_rows[query]:
        v = compare(rows, w)
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
    """A value altered, a row dropped, the ORDER BY broken: each refused."""
    rows = port_rows[query][0]
    v = compare(_altered(rows), want[query])
    assert not v.ok or v.float_err > FLOAT_LIMIT
    assert not compare({k: c[:-1] for k, c in rows.items()}, want[query]).ok
    if len(next(iter(rows.values()))) > 1 and want[query].order_by:
        flipped = {k: c[::-1] for k, c in rows.items()}
        assert flipped != rows
        assert not compare(flipped, want[query]).ok


def test_control_fails_every_query_that_returns_money(control_rows, want):
    """In the port's place, the float32 reference fails the exact columns
    of every query that returns a decimal (Q2, Q11, Q15, Q19, Q22); it
    passes the exact columns of the others, and the float values of Q8,
    Q14 and Q17 (ratios and a mean of money) are not the exact reference's."""
    money = [q for q in QUERIES if _money(want[q])]
    assert money == ["q2", "q11", "q15", "q19", "q22"]
    for q in QUERIES:
        v = compare(control_rows[q].answer(), want[q])
        assert v.ok != (q in money), (q, v.reason)
        if any(k == "float" for _, k in want[q].columns):
            assert v.float_err > 0, q


@pytest.mark.parametrize("query", QUERIES)
def test_reference_answers_its_own_check(query, want):
    """The exact reference in the port's place passes: its answer is in
    ORDER BY order and cut to the LIMIT."""
    v = compare(want[query].answer(), want[query])
    assert v.ok and v.float_err == 0.0, v.reason


@pytest.mark.parametrize("workload", CELLS)
def test_control_through_the_runs_check(workload):
    """The chip's control (``benchmark.control``) at a test's size: the
    run's own check refuses it on both of its numbers."""
    r = control.readings(workload, SEED, CPU, sf=SF)
    # at least the 13 of the 22 that return a decimal (the nine's eight and
    # five new); a float value past the limit (Q1's means, here Q14) adds one
    assert r["wrong_results"] >= 13
    assert r["float_rel_err"] > FLOAT_LIMIT


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = run.run_cell(workload, 2**31 + 99, 0.5, False, CPU, sf=SF)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 22 and out["attempted"] % 22 == 0
    assert set(out["metrics"]) == {x["name"] for x in run.metrics_for(run.manifest(), workload, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card_is_correct_and_control_is_not(workload, cuda):
    out = run.run_cell(workload, 2**31 + 7, 2.0, False, cuda, sf=1.0)
    assert out["correct"], out["checks"]
    limits = run.cell(run.manifest(), workload)[1]["limits"]
    r = control.readings(workload, 2**31 + 7, cuda, sf=1.0)
    assert r["wrong_results"] > limits["wrong_results"] and r["float_rel_err"] > limits["float_rel_err"]
