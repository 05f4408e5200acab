"""pytest settings of the benchmark's own tests (``portbench/tests``)."""


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "card: needs an NVIDIA card; decides inside the test and "
      "skips with a reason without one")
