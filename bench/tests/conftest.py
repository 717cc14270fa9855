"""The benchmark's own tests (not collected by the repository's tier-1
run): ``python -m pytest bench/tests``.  Tests marked ``card`` need a CUDA
card and skip without one; they decide inside the test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
