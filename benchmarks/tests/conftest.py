"""CPU tests of the benchmark (``python -m pytest benchmarks/tests``).
Tests that need the card carry the ``card`` marker and skip, inside a
fixture, where there is none; ``python -m pytest benchmarks/tests -m card``
runs them on the card."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
