"""pytest settings of the benchmark's own tests (benchmark/tests/):
the ``chip`` marker, for tests that need a CUDA card.  Each such test
decides inside itself whether a card is present."""


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'chip: needs a CUDA card; skips without one')
