"""The benchmark's CPU tests: python -m pytest h100_bench/tests -q from the
repository's root. Tests that need a card are marked ``cuda``; whether one
exists is decided inside the ``cuda_card`` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
