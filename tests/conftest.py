"""Test configuration. NOTE: no XLA_FLAGS here by design -- smoke tests
and benches must see the real (1-CPU) device; only the dry-run script
forces 512 placeholder devices."""

import pytest


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run slow end-to-end tests")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slow end-to-end test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
