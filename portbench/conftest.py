"""pytest wiring of the benchmark's own tests: the ``gpu`` marker. Tests
that need a card take the ``card`` fixture, which skips without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
