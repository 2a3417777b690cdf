"""Hamiltonians in spectral (diagonalized) form (port of
`qhbmlib_tpu/models/hamiltonian.py`).

A Hamiltonian pairs a BitstringEnergy (the eigenvalues) with a
QuantumCircuit (the eigenvectors): H = U E U^dagger.  It precomputes the
dagger circuit, which shares the circuit's parameters, and, when the energy
is a PauliMixin, its operator shards.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from qhbmlib_tpu_torch.models import circuit as circuit_model
from qhbmlib_tpu_torch.models import energy as energy_model


class Hamiltonian:
  """Diagonalized representation of a Hermitian operator."""

  def __init__(self, input_energy: energy_model.BitstringEnergy,
               input_circuit: circuit_model.QuantumCircuit,
               name: Optional[str] = None):
    if input_energy.num_bits != input_circuit.num_qubits:
      raise ValueError("`input_energy` and `input_circuit` must act on the "
                       "same number of bits.")
    self.name = name or "Hamiltonian"
    self.energy = input_energy
    self.circuit = input_circuit
    self.circuit_dagger = input_circuit**-1
    self.operator_shards = None
    if isinstance(input_energy, energy_model.PauliMixin):
      self.operator_shards = tuple(
          input_energy.operator_shards(input_circuit.num_qubits))

  @property
  def params(self) -> Dict[str, List[torch.nn.Parameter]]:
    """{'energy': energy parameters, 'circuit': circuit parameters}."""
    return {"energy": list(self.energy.parameters()),
            "circuit": list(self.circuit.parameters())}

  def parameters(self) -> List[torch.nn.Parameter]:
    return self.params["energy"] + self.params["circuit"]

  def set_params(self, params: Dict[str, torch.Tensor]) -> None:
    """Copies {'energy': tensor, 'circuit': tensor} (see convert.py) into
    the parameters of the energy and of the circuit: a tensor into a
    module's one parameter, a tuple of tensors into its parameters in
    order (QAIA's etas, thetas, gammas)."""
    with torch.no_grad():
      for key, value in params.items():
        values = value if isinstance(value, tuple) else (value,)
        targets = self.params[key]
        if len(values) != len(targets):
          raise ValueError(f"params[{key!r}] holds {len(values)} tensors "
                           f"for {len(targets)} parameters")
        for param, v in zip(targets, values):
          param.copy_(v.reshape(param.shape))
