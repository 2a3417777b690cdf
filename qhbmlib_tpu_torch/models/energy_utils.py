"""Layers used by the energy models (port of
`qhbmlib_tpu/models/energy_utils.py`, main-path subset)."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import nn as qnn_init


def check_bits(bits: List[int]) -> List[int]:
  """Validates a list of bit indices (duplicates would alias energy terms)."""
  if len(set(bits)) != len(bits):
    raise ValueError(f"bit index list contains duplicates: {bits}")
  return bits


class SpinsFromBitstrings(nn.Module):
  """Maps bits to spins: |0> -> +1, |1> -> -1."""

  def forward(self, inputs: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 * inputs.to(torch.float32)


class VariableDot(nn.Module):
  """Dot product with a trainable [num_inputs] kernel on `device` (None
  means the CUDA card, `device.resolve`)."""

  def __init__(self, num_inputs: int,
               initializer: Optional[qnn_init.Initializer] = None,
               device=None):
    super().__init__()
    initializer = initializer or qnn_init.RandomUniform()
    self.kernel = nn.Parameter(initializer([num_inputs],
                                           device_lib.resolve(device)))

  def forward(self, inputs: torch.Tensor) -> torch.Tensor:
    return torch.sum(inputs.to(torch.float32) * self.kernel, dim=-1)
