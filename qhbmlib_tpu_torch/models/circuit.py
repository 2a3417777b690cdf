"""Parameterized quantum circuit models (port of
`qhbmlib_tpu/models/circuit.py`, main-path subset).

A circuit model is an nn.Module holding a static `circuit_ir.Circuit` and
the trainable map to its symbol values.  `resolved_values()` permutes the
values into the IR's slot order, which the simulation functions consume.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import nn as qnn_init
from qhbmlib_tpu_torch.ops import circuit_ir as ir


class QuantumCircuit(nn.Module):
  """A parameterized circuit; subclasses define `symbol_values()` in
  `symbol_names` order.  `device` None means the CUDA card
  (`device.resolve`)."""

  def __init__(self, pqc: ir.Circuit, symbol_names: Sequence[str],
               name: Optional[str] = None, device=None):
    super().__init__()
    if set(symbol_names) != set(pqc.symbol_names):
      raise ValueError("symbol_names must match the circuit's symbols; "
                       f"got {symbol_names} vs {pqc.symbol_names}")
    self.name = name or "QuantumCircuit"
    self._pqc = pqc
    self._symbol_names = tuple(symbol_names)
    pos = {s: i for i, s in enumerate(symbol_names)}
    self.register_buffer(
        "_perm",
        torch.as_tensor(np.asarray([pos[s] for s in pqc.symbol_names],
                                   np.int64),
                        device=device_lib.resolve(device)),
        persistent=False)

  @property
  def pqc(self) -> ir.Circuit:
    return self._pqc

  @property
  def num_qubits(self) -> int:
    return self._pqc.num_qubits

  @property
  def symbol_names(self) -> Sequence[str]:
    return self._symbol_names

  def symbol_values(self) -> torch.Tensor:
    raise NotImplementedError()

  def resolved_values(self) -> torch.Tensor:
    """Symbol values in the IR's slot order."""
    return self.symbol_values()[self._perm]


class DirectQuantumCircuit(QuantumCircuit):
  """One trainable value per symbol, symbols sorted by name (as the
  reference's DirectQuantumCircuit, `models/circuit.py:210-224`)."""

  def __init__(self, pqc: ir.Circuit,
               initializer: Optional[qnn_init.Initializer] = None,
               name: Optional[str] = None, device=None):
    symbol_names = tuple(sorted(pqc.symbol_names))
    device = device_lib.resolve(device)
    super().__init__(pqc, symbol_names, name, device)
    initializer = initializer or qnn_init.RandomUniform(0, 2)
    self.values = nn.Parameter(initializer([len(symbol_names)], device))

  def symbol_values(self) -> torch.Tensor:
    return self.values
