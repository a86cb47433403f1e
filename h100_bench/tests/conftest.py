"""The benchmark's CPU tests import it as ``h100_bench`` from the checkout's root."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tiny(tmp_path):
    import tiny as tiny_mod

    return tiny_mod.tiny_root(str(tmp_path))


@pytest.fixture
def card():
    """Skips where there is no CUDA device (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
