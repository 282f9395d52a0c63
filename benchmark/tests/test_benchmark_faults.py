"""A whole run of a cell on the CPU at SF 0.01, past the harness's look for
a card, with the port's timed path broken underneath: each fault this
cell can have must turn ``correct`` false, and the unbroken run must stay
true.  (A one-chip cell has no exchange between chips to leave out.)"""

import datetime

import pytest
import torch

from benchmark import run
from datafusion_tpu_torch.columnar.table import Table

CPU = torch.device("cpu")
SEED = 2**31 + 99


def _altered(d: dict) -> dict:
    """An answer altered where it is produced: the last value of the last
    column changes."""
    d = {k: list(v) for k, v in d.items()}
    col = d[list(d)[-1]]
    if col:
        v = col[-1]
        col[-1] = (v + "x" if isinstance(v, str) else v + datetime.timedelta(days=1)
                   if isinstance(v, datetime.date) else v * (1 + 1e-6) + 1)
    return d


def _half(d: dict) -> dict:
    """Half of the rows left out (a one-row result loses its row)."""
    return {k: list(v)[: len(v) // 2] for k, v in d.items()}


class _Stale:
    """Every other result is the one before it: a step that hands back its
    state unchanged."""

    def __init__(self):
        self.last, self.n = None, 0

    def __call__(self, d: dict) -> dict:
        self.n += 1
        if self.n % 2 == 0 and self.last is not None:
            return self.last
        self.last = d
        return d


@pytest.mark.parametrize("workload", ["sf10_dev.nine", "sf10_host.nine", "sf10_dev.nine_spec"])
def test_sound_run_is_correct(workload):
    out = run.run_cell(workload, SEED, 0.5, False, CPU, sf=0.01)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 9
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {x["name"] for x in run.metrics_for(run.manifest(), workload, False)}
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 3


@pytest.mark.parametrize("fault", [_altered, _half, _Stale()], ids=["altered", "half", "stale"])
@pytest.mark.parametrize("workload", ["sf10_dev.nine", "sf10_dev.nine_spec"])
def test_fault_turns_correct_false(workload, fault, monkeypatch):
    orig = Table.to_pydict
    monkeypatch.setattr(Table, "to_pydict", lambda self: fault(orig(self)))
    out = run.run_cell(workload, SEED, 0.5, False, CPU, sf=0.01)
    assert not out["correct"]
    assert out["failed"] > 0 and out["checks"]["wrong_results"]["value"] > 0


def test_traced_run_reports_per_layer_metrics():
    out = run.run_cell("sf10_host.nine", SEED, 0.5, True, CPU, sf=0.01)
    assert out["correct"]
    assert {"frontend_ms", "collect_ms", "decode_ms"} <= set(out["metrics"])  # no device on the CPU
    assert "breakdown" in out and "window_s" in out["device"]
