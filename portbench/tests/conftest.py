"""Test settings of the benchmark's own tests: the `card` marker (tests that
need an NVIDIA card skip here, deciding inside the test), and the
checkout's root on the path."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")
