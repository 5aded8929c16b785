"""Pytest settings of the benchmark's own tests (``test_harness.py``):
the ``card`` marker for tests that need the card."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs an NVIDIA card; skips without one')
