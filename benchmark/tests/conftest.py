"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skipped where there is none)")


@pytest.fixture
def cuda():
    """The card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)
