"""The benchmark's tests. ``card`` marks a test that needs a CUDA device:
the ``card`` fixture skips it, with its reason, where there is none, and
decides so inside the test's run, never at import or collection."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the workers of a parallel run share the
    cores (restored after the test)."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
