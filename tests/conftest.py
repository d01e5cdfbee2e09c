"""Registers the ``gpu`` marker: tests that need a CUDA card. They decide
inside a fixture whether one is present and skip with a reason when not."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")
