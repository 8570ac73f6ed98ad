"""Fixtures of the benchmark's own tests.

CPU tests run here with the rest; tests marked ``cuda`` need a card and
skip without one. On the card:

    python -m pytest -o addopts="" -p no:cacheprovider cgbench/tests -q
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _one_cpu_thread():
    """The CPU tests' tensors are small: one thread a worker, so that
    parallel workers do not spin against each other's thread pools."""
    torch.set_num_threads(1)


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda", 0)
