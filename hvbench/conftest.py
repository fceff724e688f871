"""pytest settings of the benchmark's own tests (`hvbench/tests`): the
`chip` marker, for a test that needs an NVIDIA card and skips without
one (decided inside the test)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skipped without one")
