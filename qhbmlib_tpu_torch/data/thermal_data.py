"""Exact thermal-state quantum data (port of
`qhbmlib_tpu/data/thermal_data.py`): expectations tr[rho K] against a fixed
density matrix rho, e.g. a Gibbs state from `baselines.utils`.

The reference measures a Hamiltonian K = U diag(E) U^dagger by building the
dense 2^n x 2^n unitary and differentiating through it.  Here rho is
diagonalized once, rho = sum_k l_k |v_k><v_k|, and

    d[x] = <x|U^dagger rho U|x> = sum_k l_k |(U^dagger v_k)[x]|^2,
    tr[rho K] = sum_x d[x] E(x):

one batched forward of U^dagger over the 2^n eigenvectors and one batched
reverse sweep (`adjoint.batched_probabilities`: K4 / K1 and K5 on the
card), exact like the reference, for any BitstringEnergy.  Every l_k is
kept: dropping small ones would change the value.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import utils
from qhbmlib_tpu_torch.data import quantum_data
from qhbmlib_tpu_torch.models import hamiltonian as hamiltonian_model
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.ops import statevector as sv


def _pauli_trace(rho: np.ndarray, row, num_qubits: int) -> float:
  """Re tr[rho P] in float64 for one Pauli string (codes `row`, qubit 0
  the most significant index bit): P|a> = i^#Y (-1)^{#(Y,Z bits set in a)}
  |a ^ flip>, so tr[rho P] = sum_a rho[a, a ^ flip] times that phase."""
  a = np.arange(rho.shape[0], dtype=np.int64)
  flip, phase, sign = 0, 1.0 + 0j, np.ones(a.shape)
  for q, code in enumerate(row):
    bit = 1 << (num_qubits - 1 - q)
    if code in (paulis.X, paulis.Y):
      flip |= bit
    if code in (paulis.Y, paulis.Z):
      sign = sign * (1.0 - 2.0 * ((a & bit) != 0))
    if code == paulis.Y:
      phase *= 1j
  return float(np.real(phase * np.sum(rho[a, a ^ flip] * sign)))


class ThermalStateData(quantum_data.QuantumData):
  """QuantumData serving exact expectations against a fixed density matrix.

  rho is held in float64 on the host and eigendecomposed once
  (`numpy.linalg.eigh`); the weights l_k go to `device` (None means the
  CUDA card, `device.resolve`) as float32 [2^n], the eigenvectors as
  float32 [2^n, R, C] planes (state k is column k of the eigenvector
  matrix, in the [R, C] layout's big-endian flat order).  Setting `plain`
  runs the kernels' plain versions (the precision gate's reference arm,
  `bench.plain_loss`)."""

  def __init__(self, density_matrix, device=None):
    rho = np.asarray(density_matrix, np.complex128)
    dim = rho.shape[0]
    n = dim.bit_length() - 1
    if rho.shape != (dim, dim) or dim != 2**n:
      raise ValueError(f"density matrix of shape {rho.shape} is not "
                       "2^n x 2^n")
    self._rho = rho
    self._num_qubits = n
    self.plain = False
    self.device = device_lib.resolve(device)
    evals, evecs = np.linalg.eigh(rho)
    self.weights = torch.tensor(evals, dtype=torch.float32,
                                device=self.device)
    states = evecs.T.reshape((dim,) + sv.state_shape(n))  # row k = v_k
    self.planes = tuple(torch.tensor(part, dtype=torch.float32,
                                     device=self.device)
                        for part in (states.real, states.imag))
    self.all_bitstrings = utils.all_bitstrings(n, self.device)
    self._traces = {}  # Pauli code row -> Re tr[rho P]

  @property
  def num_qubits(self) -> int:
    return self._num_qubits

  @property
  def density_matrix(self) -> torch.Tensor:
    """rho as a complex128 host tensor."""
    return torch.from_numpy(self._rho)

  @property
  def params(self) -> dict:
    """The data's parameters: none."""
    return {}

  def basis_weights(self, observable: hamiltonian_model.Hamiltonian
                    ) -> torch.Tensor:
    """[2^n] d[x] = <x|U^dagger rho U|x> for the Hamiltonian's circuit U,
    differentiable w.r.t. its parameters (adjoint)."""
    dagger = observable.circuit_dagger
    probs = adjoint.batched_probabilities(
        dagger.pqc, dagger.resolved_values(), self.planes, plain=self.plain)
    return (self.weights[:, None] * probs.flatten(1)).sum(0)

  def expectation(self, observable,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """tr[rho K], a scalar: for a Hamiltonian sum_x d[x] E(x), with
    gradients to its circuit's parameters (through the shared dagger) and
    its energy's (autograd); for a PauliSum sum_t Re(c_t) tr[rho P_t], with
    the coefficients' gradients.  `generator` is ignored: the data is
    exact."""
    del generator
    if isinstance(observable, hamiltonian_model.Hamiltonian):
      return self.basis_weights(observable) @ observable.energy(
          self.all_bitstrings)
    traces = []
    for row in observable.code_rows():
      if row not in self._traces:
        self._traces[row] = _pauli_trace(self._rho, row, self._num_qubits)
      traces.append(self._traces[row])
    coeffs = observable.coeffs
    return torch.sum(coeffs.real * torch.tensor(traces, dtype=torch.float32,
                                                device=coeffs.device))
