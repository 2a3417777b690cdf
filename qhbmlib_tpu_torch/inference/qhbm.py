"""Quantum Hamiltonian-based models (port of `qhbmlib_tpu/inference/qhbm.py`).

A QHBM pairs an EnergyInference (the eigenvalue distribution p_theta) with a
QuantumInference (the eigenvector circuit U_phi); the thermal state is
rho = sum_x p_theta(x) U_phi|x><x|U_phi^dagger, the normalized exponential
of the modular Hamiltonian K = U_phi E_theta U_phi^dagger.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from qhbmlib_tpu_torch import utils
from qhbmlib_tpu_torch.inference import ebm
from qhbmlib_tpu_torch.inference import qnn
from qhbmlib_tpu_torch.models import hamiltonian as hamiltonian_model


class QHBM:
  """Inference methods for a QHBM; its weights are the energy's parameters
  (theta) and the circuit's parameters (phi)."""

  def __init__(self, input_ebm: ebm.EnergyInference,
               input_qnn: qnn.QuantumInference, name: Optional[str] = None):
    self._e_inference = input_ebm
    self._q_inference = input_qnn
    self.name = name or "QHBM"
    self._modular_hamiltonian = hamiltonian_model.Hamiltonian(
        input_ebm.energy, input_qnn.circuit)

  @property
  def e_inference(self) -> ebm.EnergyInference:
    return self._e_inference

  @property
  def q_inference(self) -> qnn.QuantumInference:
    return self._q_inference

  @property
  def modular_hamiltonian(self) -> hamiltonian_model.Hamiltonian:
    """K = U_phi E_theta U_phi^dagger, on this QHBM's own parameters."""
    return self._modular_hamiltonian

  @property
  def params(self) -> Dict[str, List[torch.nn.Parameter]]:
    """{'theta': energy parameters, 'phi': circuit parameters}."""
    return {"theta": list(self._e_inference.energy.parameters()),
            "phi": list(self._q_inference.circuit.parameters())}

  def parameters(self) -> List[torch.nn.Parameter]:
    return self.params["theta"] + self.params["phi"]

  def set_params(self, params: Dict[str, torch.Tensor]) -> None:
    """Copies {'theta': tensor, 'phi': tensor} (see convert.py) into
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

  def circuits(self, num_samples: int,
               generator: Optional[torch.Generator] = None):
    """A thermally distributed sample of eigenstates: (unique bitstrings
    [U, n] int8, counts [U] int32); state i is U_phi|bitstrings[i]>."""
    samples = self._e_inference.sample(num_samples, generator)
    bitstrings, _, counts = utils.unique_bitstrings_with_counts(samples)
    return bitstrings, counts

  def expectation(self, observables: qnn.Observable,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """[n_ops] expectations against the thermal state ([1] for a
    Hamiltonian): the EBM's eq. A5 average of the QNN's expectation over its
    support, so the energy's parameters get the score-function gradient and
    the circuit's (and the observable's) the adjoint one."""
    q_inf = self._q_inference
    return self._e_inference.expectation(
        lambda bits: q_inf.expectation(bits, observables, dedup=False),
        generator)
