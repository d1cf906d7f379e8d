"""The benchmark's CPU tests: its harness and the files it finds by name
on the path, and the ``cuda`` marker for tests that need the card."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
# appended, so that no module of the repository's own tests is shadowed
for p in (BENCH.parent / "src", BENCH / "reference", BENCH / "tests",
          BENCH):
    if str(p) not in sys.path:
        sys.path.append(str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped on a host without "
        "one")
