"""The benchmark's own tests. They run from the root of the checkout:

    python -m pytest portbench/tests            # CPU: the card's tests skip
    python -m pytest portbench/tests -m cuda    # on a machine with a GPU

Tests marked ``cuda`` need a CUDA device and skip without one; the device
is looked for inside the ``cuda_device`` fixture, never at import time.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: small batched solves on several threads are
    slower here, and some LAPACK builds stall on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
