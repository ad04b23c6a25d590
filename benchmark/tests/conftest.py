"""pytest settings of the benchmark's own tests (run them with
`python -m pytest benchmark/tests`; the repository's `tests/` does not
collect them).  Tests that need a CUDA card carry the `card` marker and
take the `card` fixture, which skips them where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (the benchmark's runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on the card")
