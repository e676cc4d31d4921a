"""Tests of the benchmark itself: ``python -m pytest lwg_bench/tests``
from the repository's root (the CPU tests); on a card host
``python -m pytest lwg_bench/tests -m cuda`` runs the card's too."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present (decided here, at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
