import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "sm90: needs an NVIDIA sm_90 (Hopper) card; skipped "
        "elsewhere by the test's own fixture")
