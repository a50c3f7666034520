"""The benchmark's own tests: ``python3 -m pytest -q lpfbench/tests``
from the repository's root (the card's tests: add ``-m gpu`` on a
machine with one; here they skip)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, when the
    test runs, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
