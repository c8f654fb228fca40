"""portbench's tests: on the CPU at small sizes, and, marked `card`, on one
CUDA GPU (`python -m pytest portbench/tests -m card` on the card)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA GPU (skips, with its reason, without)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels and the "
                    "benchmark's timers run only on the card")
