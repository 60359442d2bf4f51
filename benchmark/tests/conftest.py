"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q`.

Tests marked `card` need the CUDA card and skip without one; they run on
the card by the same command there."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card")
