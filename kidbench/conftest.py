"""The benchmark's own tests (``kidbench/tests``): the ``card`` marker for
those that need an NVIDIA card, which skip inside a fixture elsewhere,
and the program's table cache inside the checkout."""
import os
from pathlib import Path

import pytest

os.environ.setdefault("KID_TPU_TORCH_TABLE_CACHE", str(
    Path(__file__).resolve().parents[1] / "build" / "kidbench" / "tables"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")
