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
from qhbmlib_tpu_torch.ops import paulis


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

  def __add__(self, other: "QuantumCircuit") -> "QuantumCircuit":
    """This circuit, then `other`; their symbols must be disjoint (as the
    reference's `__add__`, `models/circuit.py:172-192`).  The sum holds
    both summands, not copies: it trains their parameters."""
    if not isinstance(other, QuantumCircuit):
      raise TypeError("can only add QuantumCircuit to QuantumCircuit")
    if set(self.symbol_names) & set(other.symbol_names):
      raise ValueError("Circuits to be summed must not have symbols in common.")
    return SumCircuit(self, other)

  def __pow__(self, exponent: int) -> "QuantumCircuit":
    """The inverse circuit, on this circuit's own parameters (as the
    reference's `__pow__`, `models/circuit.py:194-207`)."""
    if exponent != -1:
      raise ValueError("Only the inverse (exponent == -1) is supported.")
    return InverseCircuit(self)


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


class ConstantCircuit(QuantumCircuit):
  """A circuit of constant gates only (the reference's symbol-free
  `QuantumCircuit(u, (), [], [])`, `baselines/train.py:724`): no
  parameters, an empty `symbol_values()`.  Summed after a parameterized
  circuit it appends its gates to that circuit's (a Trotter channel)."""

  def __init__(self, pqc: ir.Circuit, name: Optional[str] = None,
               device=None):
    device = device_lib.resolve(device)
    super().__init__(pqc, (), name or "ConstantCircuit", device)
    self.register_buffer("_no_values",
                         torch.zeros([0], dtype=torch.float32, device=device),
                         persistent=False)

  def symbol_values(self) -> torch.Tensor:
    return self._no_values


class QAIA(QuantumCircuit):
  """The quantum-classical ansatz with tied parameters (reference
  `models/circuit.py:226-276`): each of `num_layers` layers applies
  exp(-i gamma_{l,k} H_k) for each quantum term H_k, then
  exp(-i eta_l theta_j C_j) for each classical term C_j, each term of a sum
  as one PROT (`circuit_ir.exp_pauli_sum`).

  Its parameters, in the reference's `trainable_variables` order: `etas`
  [L], `thetas` [num_classical], `gammas` [L, num_quantum].  The symbol
  values are layer-major, [gammas_l, etas_l * thetas] for each layer l, in
  the reference's flat (unsorted) symbol order.  `initializer` draws all
  three (default U[0, 2 pi), as the reference's); `device` None means the
  CUDA card (`device.resolve`)."""

  def __init__(self, quantum_h_terms: Sequence[paulis.PauliSum],
               classical_h_terms: Sequence[paulis.PauliSum],
               num_layers: int,
               initializer: Optional[qnn_init.Initializer] = None,
               name: Optional[str] = None, device=None):
    device = device_lib.resolve(device)
    initializer = initializer or qnn_init.RandomUniform(0, 2 * np.pi)
    terms = list(quantum_h_terms) + list(classical_h_terms)
    num_qubits = max(t.num_qubits for t in terms)
    builder = ir.CircuitBuilder(num_qubits)
    prefix = name or f"qaia{id(self)}"
    flat_symbols = []
    for layer in range(num_layers):
      for kind, group in (("gamma", quantum_h_terms),
                          ("eta", classical_h_terms)):
        for k, term in enumerate(group):
          sym = f"{prefix}_{kind}_{layer}_{k}"
          # exp_pauli_sum reads the coefficients through numpy.
          ir.exp_pauli_sum(paulis.PauliSum(term.codes,
                                           term.coeffs.detach().cpu(),
                                           term.num_qubits),
                           symbol=sym, builder=builder)
          flat_symbols.append(sym)
    super().__init__(builder.build(), tuple(flat_symbols), name or "QAIA",
                     device)
    self.etas = nn.Parameter(initializer([num_layers], device))
    self.thetas = nn.Parameter(initializer([len(classical_h_terms)], device))
    self.gammas = nn.Parameter(initializer([num_layers,
                                            len(quantum_h_terms)], device))

  def symbol_values(self) -> torch.Tensor:
    classical = self.etas[:, None] * self.thetas[None, :]  # [L, C]
    return torch.cat([self.gammas, classical], dim=1).reshape(-1)


class SumCircuit(QuantumCircuit):
  """`first + second`: the concatenated IR, whose symbol values are the
  summands' `symbol_values()` in turn (both modules held as submodules)."""

  def __init__(self, first: QuantumCircuit, second: QuantumCircuit):
    super().__init__(first.pqc.append(second.pqc),
                     tuple(first.symbol_names) + tuple(second.symbol_names),
                     f"{first.name}_{second.name}", first._perm.device)
    self.summands = nn.ModuleList([first, second])

  def symbol_values(self) -> torch.Tensor:
    return torch.cat([c.symbol_values() for c in self.summands])


class InverseCircuit(QuantumCircuit):
  """`circuit**-1`: the reversed IR of inverted gates (`Circuit.inverse`)
  on the original module's symbol values."""

  def __init__(self, circuit: QuantumCircuit):
    super().__init__(circuit.pqc.inverse(), circuit.symbol_names,
                     f"{circuit.name}_inverse", circuit._perm.device)
    self.original = circuit

  def symbol_values(self) -> torch.Tensor:
    return self.original.symbol_values()
