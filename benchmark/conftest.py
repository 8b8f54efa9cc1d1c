"""pytest settings of the benchmark's own tests (benchmark/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; the test itself skips without one")
