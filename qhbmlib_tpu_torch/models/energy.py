"""Energy-function models over bitstrings (port of
`qhbmlib_tpu/models/energy.py`: BitstringEnergy, PauliMixin,
BernoulliEnergy, KOBE).

An energy is an nn.Module: `energy(bitstrings [batch, n]) -> [batch]`, with
its trainable weights as `nn.Parameter`s.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Sequence

import torch
from torch import nn

from qhbmlib_tpu_torch import nn as qnn_init
from qhbmlib_tpu_torch.models import energy_utils
from qhbmlib_tpu_torch.ops import paulis


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


class PauliMixin(abc.ABC):
  """A Pauli-Z operator form of an energy (reference `PauliMixin`,
  `models/energy.py:88-117`): E as `post_process` applied to the
  expectations of parameter-free Z-string shards."""

  @property
  @abc.abstractmethod
  def post_process(self) -> List[nn.Module]:
    """Layers mapping shard expectations [..., S] to the energy [...]."""

  @abc.abstractmethod
  def operator_shards(self, num_qubits: int) -> Sequence[paulis.PauliSum]:
    """The Z strings to measure, one single-term PauliSum a shard."""

  def operator_expectation(self, expectation_shards: torch.Tensor):
    """The average energy from shard expectations [..., S]."""
    x = expectation_shards
    for layer in self.post_process:
      x = layer(x)
    return x


class BernoulliEnergy(BitstringEnergy, PauliMixin):
  """Independent spins in magnetic fields: E(x) = sum_i theta_i s_i.  Its
  kernel lives on `device` (None means the CUDA card, `device.resolve`).
  Its operator form measures Z_i on each bit, then its `VariableDot`."""

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

  @property
  def post_process(self) -> List[nn.Module]:
    return [self.energy_layers[-1]]

  def operator_shards(self, num_qubits: int) -> Sequence[paulis.PauliSum]:
    """Z_i on each qubit i, coeffs on the kernel's device."""
    return paulis.z_strings_from_masks(
        [[1 if q == i else 0 for q in range(num_qubits)]
         for i in range(num_qubits)], num_qubits, self.kernel.device)


class KOBE(BitstringEnergy, PauliMixin):
  """K-th order binary energy: E(x) = sum_t w_t prod_{i in c_t} s_i over
  every combination c_t of <= `order` bits (reference
  `models/energy.py:155-183`).  Its kernel and parity mask live on
  `device` (None means the CUDA card, `device.resolve`).  Its operator form
  measures the Z string of each combination, in the same order, then its
  `VariableDot`."""

  def __init__(self, bits: List[int], order: int,
               initializer: Optional[qnn_init.Initializer] = None,
               name: Optional[str] = None, device=None):
    parity = energy_utils.Parity(bits, order, device)
    dot = energy_utils.VariableDot(parity.num_terms, initializer, device)
    super().__init__(bits, [energy_utils.SpinsFromBitstrings(), parity, dot],
                     name)
    self.num_terms = parity.num_terms
    self.indices = parity.indices

  @property
  def kernel(self) -> nn.Parameter:
    return self.energy_layers[-1].kernel

  @property
  def post_process(self) -> List[nn.Module]:
    return [self.energy_layers[-1]]

  def operator_shards(self, num_qubits: int) -> Sequence[paulis.PauliSum]:
    """Z on each qubit of each combination, coeffs on the kernel's
    device."""
    return paulis.z_strings_from_masks(
        [[1 if q in combo else 0 for q in range(num_qubits)]
         for combo in self.indices], num_qubits, self.kernel.device)
