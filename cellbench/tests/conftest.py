"""Shared set-up of the benchmark's CPU tests: the port's sources on the
path and the `cuda` marker (tests that need a card skip without one)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (repro_torch kernels); skips without one")
