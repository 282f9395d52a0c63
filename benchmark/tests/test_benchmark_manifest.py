"""BENCHMARK.json against the benchmark's contract, and every file a cell
is found by: its configuration, its mix, the mix's query texts and
reference modules, and each metric's reader."""

import importlib
import json
import re
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
HERE = CHECKOUT / "benchmark"
M = json.loads((CHECKOUT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def reported(cell: str, metrics: list) -> set:
    return {x["name"] for x in metrics if cell in x.get("workloads", [cell])}


def test_top_level_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (CHECKOUT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(M["command"]) <= 32
    for w in M["command"]:
        assert line(w) and not w.startswith("/") and ".." not in w


def test_names_units_and_keys():
    groups = [M["configs"], M["workloads"], M["end_to_end"] + M["per_layer"]]
    for g in groups:
        names = [x["name"] for x in g]
        assert len(names) == len(set(names)), names
        assert all(NAME.match(n) for n in names), names
    for x in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in M["end_to_end"]:
        assert set(x) - {"workloads"} == E2E_KEYS
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in M["per_layer"]:
        assert set(x) - {"workloads"} == LAYER_KEYS
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(x["layer"])


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        body = json.loads((CHECKOUT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert set(body["host_tables"]) <= {"lineitem", "orders", "customer", "part", "partsupp",
                                            "supplier", "nation", "region"}
        assert body["limits"]["wrong_results"] == 0 and body["limits"]["float_rel_err"] > 0


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in M["configs"]}
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs and line(w["why"])
        assert NAME.match(w["traffic"])
        mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
        assert mix["streams"] == 1 and mix["loop"] == "closed"
        for q in mix["queries"]:
            assert (HERE / "queries" / f"{q}.sql").is_file(), q
            ref = importlib.import_module(f"benchmark.reference.{q}")
            assert callable(ref.run) and ref.COLUMNS and ref.LIMIT in (None, *range(1, 10**6))


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e, layer = reported(cell, M["end_to_end"]), reported(cell, M["per_layer"])
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for x in M["per_layer"]:
        if cell in x.get("workloads", [cell]):
            assert x["moves"] in e2e, (x["name"], x["moves"])


def test_every_metric_has_a_reader():
    cells = {w["name"] for w in M["workloads"]}
    for x in M["end_to_end"] + M["per_layer"]:
        assert set(x.get("workloads", cells)) <= cells
        mod = importlib.import_module(f"benchmark.metrics.{x['name'].split('.')[0]}")
        assert callable(mod.read)
    assert any(x["name"] == "setup_s" and x["bound"] <= 0.25 for x in M["end_to_end"])
