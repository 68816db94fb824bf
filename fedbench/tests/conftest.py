"""Shared fixtures of the benchmark's tests: the checkout on ``sys.path`` and
the card, looked for inside a fixture (never at import)."""

from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda fedbench/tests` on the card")
    return torch.device("cuda", 0)
