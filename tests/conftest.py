"""Registers the ``cuda`` marker for tests that need an NVIDIA Hopper card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA Hopper card (sm_90a); such a test skips itself "
        "when none is present")
