"""The benchmark's own tests: run from the repository root,
``python -m pytest slodbench/tests -q`` (CPU), and on the card
``python -m pytest slodbench/tests -m cuda``."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
