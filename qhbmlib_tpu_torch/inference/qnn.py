"""Inference on parameterized quantum circuits (port of
`qhbmlib_tpu/inference/qnn.py`, main-path subset).

`AnalyticQuantumInference` gives exact expectations of PauliSum observables
with adjoint gradients through `ops.adjoint.batched_expectations`.
"""

from __future__ import annotations

import abc
from typing import Optional

import torch

from qhbmlib_tpu_torch.models import circuit as circuit_model
from qhbmlib_tpu_torch.ops import adjoint


class QuantumInference(abc.ABC):
  """Interface for inference on quantum circuits."""

  def __init__(self, input_circuit: circuit_model.QuantumCircuit,
               name: Optional[str] = None):
    self._circuit = input_circuit
    self.name = name or type(self).__name__

  @property
  def circuit(self) -> circuit_model.QuantumCircuit:
    return self._circuit

  @abc.abstractmethod
  def expectation(self, initial_states: torch.Tensor,
                  observables) -> torch.Tensor:
    """[batch, n_ops] expectations of U|b> for each bitstring b."""


class AnalyticQuantumInference(QuantumInference):
  """Exact expectations with adjoint gradients (reference qnn.py:117-144);
  PauliSum observables only."""

  def expectation(self, initial_states: torch.Tensor,
                  observables) -> torch.Tensor:
    return adjoint.batched_expectations(
        self._circuit.pqc, self._circuit.resolved_values(), initial_states,
        adjoint.as_pauli_tuple(observables))
