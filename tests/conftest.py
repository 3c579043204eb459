import os
import sys

# Tests and benches run single-device (the dry-run sets its own 512-device
# flag in its own process); make sure nothing leaks in.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's CUDA kernels); "
        "skips without one")
