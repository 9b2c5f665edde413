import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped inside its fixture "
        "where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")
    return torch.device("cuda")
