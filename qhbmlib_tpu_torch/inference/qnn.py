"""Inference on parameterized quantum circuits (port of
`qhbmlib_tpu/inference/qnn.py`, main-path subset).

`AnalyticQuantumInference` gives exact expectations of PauliSum observables
or of Hamiltonians with a Pauli energy, with adjoint gradients through
`ops.adjoint.batched_expectations`.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence, Union

import torch

from qhbmlib_tpu_torch import utils
from qhbmlib_tpu_torch.models import circuit as circuit_model
from qhbmlib_tpu_torch.models import energy as energy_model
from qhbmlib_tpu_torch.models import hamiltonian as hamiltonian_model
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import paulis

Observable = Union[paulis.PauliSum, Sequence[paulis.PauliSum],
                   hamiltonian_model.Hamiltonian]


class QuantumInference(abc.ABC):
  """Interface for inference on quantum circuits."""

  def __init__(self, input_circuit: circuit_model.QuantumCircuit,
               name: Optional[str] = None):
    self._circuit = input_circuit
    self.name = name or type(self).__name__
    self._total_cache = {}

  @property
  def circuit(self) -> circuit_model.QuantumCircuit:
    return self._circuit

  def _total_circuit(self, observable: hamiltonian_model.Hamiltonian
                     ) -> circuit_model.QuantumCircuit:
    """self.circuit + observable.circuit_dagger, cached per Hamiltonian.

    The entry pins the Hamiltonian: ids are unique only among live objects,
    so without it a recycled id could serve a stale circuit (reference
    qnn.py:68-81)."""
    key = id(observable)
    hit = self._total_cache.get(key)
    if hit is None or hit[0] is not observable:
      hit = utils.bounded_cache_put(
          self._total_cache, key,
          (observable, self._circuit + observable.circuit_dagger))
    return hit[1]

  def expectation(self, initial_states: torch.Tensor, observables: Observable,
                  dedup: bool = True) -> torch.Tensor:
    """[batch, n_ops] expectations of U|b> for each bitstring b (n_ops = 1
    for a Hamiltonian).  With `dedup` each distinct bitstring is simulated
    once and the results expanded back (reference qnn.py:83-105); the
    estimators, whose supports are already deduplicated, pass False."""
    if not dedup:
      return self._expectation(initial_states, observables)
    unique_states, idx, _ = utils.unique_bitstrings_with_counts(
        initial_states)
    return utils.expand_unique_results(
        self._expectation(unique_states, observables), idx)

  @abc.abstractmethod
  def _expectation(self, initial_states: torch.Tensor,
                   observables: Observable) -> torch.Tensor:
    """[batch, n_ops] expectations, one simulation a row."""


class AnalyticQuantumInference(QuantumInference):
  """Exact expectations with adjoint gradients (reference qnn.py:117-144).

  A Hamiltonian observable H = V E V^dagger is measured as its energy's
  operator shards on (U + V^dagger)|b>, then the energy's post-process:
  gradients reach U's, V's and E's parameters.

  `plain=True` runs the kernels' plain PyTorch versions on any device: the
  reference arm of the bench's precision gate (the counterpart of the JAX
  bench's `QHBM_MATMUL_PRECISION=highest` arm), never the main path."""

  def __init__(self, input_circuit: circuit_model.QuantumCircuit,
               name: Optional[str] = None, plain: bool = False):
    super().__init__(input_circuit, name)
    self.plain = plain

  def _expectation(self, initial_states, observables):
    if isinstance(observables, hamiltonian_model.Hamiltonian):
      if not isinstance(observables.energy, energy_model.PauliMixin):
        raise TypeError("General Hamiltonians not accepted: the energy must "
                        "be a PauliMixin.")
      total = self._total_circuit(observables)
      shards = adjoint.batched_expectations(
          total.pqc, total.resolved_values(), initial_states,
          observables.operator_shards, plain=self.plain)  # [B, S]
      return observables.energy.operator_expectation(shards)[:, None]
    return adjoint.batched_expectations(
        self._circuit.pqc, self._circuit.resolved_values(), initial_states,
        adjoint.as_pauli_tuple(observables), plain=self.plain)
