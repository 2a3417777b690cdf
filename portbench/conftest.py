"""The benchmark's tests: CPU tests at tiny sizes, and tests marked
`card` that need the CUDA card and skip without it (decided inside the
`card` fixture, never at import)."""

import pytest
import torch


def pytest_configure(config):
  config.addinivalue_line("markers",
                          "card: needs the CUDA card (skips without it)")


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs the CUDA card")
  return torch.device("cuda")
