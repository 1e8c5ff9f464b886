"""Tests of the benchmark itself (not collected by ``pytest tests/``):

    python -m pytest portbench/tests -q          # CPU; the card's tests skip
    python -m pytest portbench/tests -q -m chip  # on a machine with the card

Tests marked ``chip`` need CUDA and skip without it; whether a card is
present is decided inside the ``cuda`` fixture, never at import.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU; skips without CUDA")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: runs on the card")
    return torch.device("cuda", 0)
