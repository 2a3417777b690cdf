"""Energy-function models over bitstrings (port of
`qhbmlib_tpu/models/energy.py`, main-path subset).

An energy is an nn.Module: `energy(bitstrings [batch, n]) -> [batch]`, with
its trainable weights as `nn.Parameter`s.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from qhbmlib_tpu_torch import nn as qnn_init
from qhbmlib_tpu_torch.models import energy_utils


class BitstringEnergy(nn.Module):
  r"""Energy function E(x) over bitstrings as a stack of layers; defines the
  EBM p(x) = exp(-E(x)) / sum_y exp(-E(y))."""

  def __init__(self, bits: List[int], energy_layers: Sequence[nn.Module],
               name: Optional[str] = None):
    super().__init__()
    self._bits = energy_utils.check_bits(list(bits))
    self.energy_layers = nn.ModuleList(energy_layers)
    self.name = name or type(self).__name__

  @property
  def num_bits(self) -> int:
    return len(self._bits)

  @property
  def bits(self) -> List[int]:
    return self._bits

  def forward(self, bitstrings: torch.Tensor) -> torch.Tensor:
    x = bitstrings
    for layer in self.energy_layers:
      x = layer(x)
    return x


class BernoulliEnergy(BitstringEnergy):
  """Independent spins in magnetic fields: E(x) = sum_i theta_i s_i.  Its
  kernel lives on `device` (None means the CUDA card, `device.resolve`)."""

  def __init__(self, bits: List[int],
               initializer: Optional[qnn_init.Initializer] = None,
               name: Optional[str] = None, device=None):
    dot = energy_utils.VariableDot(len(bits), initializer, device)
    super().__init__(bits, [energy_utils.SpinsFromBitstrings(), dot], name)

  @property
  def kernel(self) -> nn.Parameter:
    return self.energy_layers[-1].kernel

  @property
  def logits(self) -> torch.Tensor:
    """p(bit=1) = e^theta/(e^theta + e^-theta)  =>  logit = 2*theta."""
    return 2.0 * self.kernel
