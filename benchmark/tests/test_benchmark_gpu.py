"""On the card at SF 1 (skipped without one): a short run of each cell is
correct, and the control in the port's place is not."""

import pytest

from benchmark import control, run

CELLS = ["sf10_dev.nine", "sf10_host.nine", "sf10_dev.nine_spec"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_is_correct_and_control_is_not(workload, cuda):
    out = run.run_cell(workload, 2**31 + 7, 2.0, False, cuda, sf=1.0)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    limits = run.cell(run.manifest(), workload)[1]["limits"]
    r = control.readings(workload, 2**31 + 7, cuda, sf=1.0)
    assert r["wrong_results"] > limits["wrong_results"] and r["float_rel_err"] > limits["float_rel_err"]
