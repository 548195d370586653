"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that need the card (they skip without one)."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (the benchmark's card tests)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
