"""Test bootstrap: vendor a deterministic `hypothesis` fallback.

The property tests import `hypothesis`; on environments without it (see
requirements-dev.txt) we register tests/_hypothesis_fallback.py under that
name so all modules still collect and run a fixed-example sweep.
"""
import sys
from pathlib import Path

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _hypothesis_fallback as _shim

    sys.modules["hypothesis"] = _shim
    sys.modules["hypothesis.strategies"] = _shim.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped on a host without "
        "one (run on the card with `PYTHONPATH=src python -m pytest "
        "tests/test_torch_cuda.py`)")
