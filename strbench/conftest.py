"""pytest settings of the benchmark's own tests (python -m pytest
strbench/tests): the `card` marker for tests that need an NVIDIA card,
which decide in a fixture, never at import, whether one is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The card's torch device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
