"""Shared set-up of the benchmark's tests: the checkout's root and
``src`` on the path, and the ``card`` marker for tests that need a CUDA
device (they skip here, deciding inside the ``card`` fixture)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; run on the card with "
        "`python -m pytest -m card perfbench/tests`")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
