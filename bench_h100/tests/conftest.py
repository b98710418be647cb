"""The benchmark's own tests: on the CPU everything but the card tests,
which carry the `card` marker and skip where torch sees no CUDA device."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips (with its reason) where there is none")
