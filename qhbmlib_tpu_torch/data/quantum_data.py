"""Interface to quantum data sources (port of
`qhbmlib_tpu/data/quantum_data.py`)."""

from __future__ import annotations

import abc
from typing import Optional

import torch


class QuantumData(abc.ABC):
  """Interface for quantum datasets."""

  @abc.abstractmethod
  def expectation(self, observable,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Expectation of an observable against this dataset (a scalar for a
    Hamiltonian or one PauliSum)."""
