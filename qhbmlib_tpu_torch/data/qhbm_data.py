"""Quantum data defined by a QHBM (port of `qhbmlib_tpu/data/qhbm_data.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from qhbmlib_tpu_torch.data import quantum_data
from qhbmlib_tpu_torch.inference import qhbm as qhbm_module


class QHBMData(quantum_data.QuantumData):
  """QuantumData whose state is a QHBM's thermal state."""

  def __init__(self, input_qhbm: qhbm_module.QHBM):
    self.qhbm = input_qhbm

  def expectation(self, observable,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """The QHBM's expectation of one observable, squeezed to a scalar."""
    return self.qhbm.expectation(observable, generator).squeeze(0)
