"""The benchmark's tests: CPU tests at a tiny size, and card tests
(marked ``cuda``) that skip where torch sees no card.

    python -m pytest benchmark/tests            # here, on the CPU
    python -m pytest benchmark/tests -m cuda    # on the card
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips elsewhere (on the "
        "card: python -m pytest benchmark/tests -m cuda)")


@pytest.fixture
def card():
    """The card, or a skip where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
