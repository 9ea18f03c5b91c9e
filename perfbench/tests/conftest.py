"""Shared settings of the benchmark's own tests: the ``card`` marker (tests
that need a CUDA card skip without one; whether one is present is decided
inside the ``card`` fixture, never at import) and the checkout root on the
path."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return "cuda:0"

