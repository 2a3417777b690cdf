"""Quantum Hamiltonian-based models (port of `qhbmlib_tpu/inference/qhbm.py`,
main-path subset).

A QHBM pairs an EnergyInference (the eigenvalue distribution p_theta) with a
QuantumInference (the eigenvector circuit U_phi); the thermal state is
rho = sum_x p_theta(x) U_phi|x><x|U_phi^dagger.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from qhbmlib_tpu_torch.inference import ebm
from qhbmlib_tpu_torch.inference import qnn


class QHBM:
  """Inference methods for a QHBM; its weights are the energy's parameters
  (theta) and the circuit's parameters (phi)."""

  def __init__(self, input_ebm: ebm.EnergyInference,
               input_qnn: qnn.QuantumInference, name: Optional[str] = None):
    self._e_inference = input_ebm
    self._q_inference = input_qnn
    self.name = name or "QHBM"

  @property
  def e_inference(self) -> ebm.EnergyInference:
    return self._e_inference

  @property
  def q_inference(self) -> qnn.QuantumInference:
    return self._q_inference

  @property
  def params(self) -> Dict[str, List[torch.nn.Parameter]]:
    """{'theta': energy parameters, 'phi': circuit parameters}."""
    return {"theta": list(self._e_inference.energy.parameters()),
            "phi": list(self._q_inference.circuit.parameters())}

  def parameters(self) -> List[torch.nn.Parameter]:
    return self.params["theta"] + self.params["phi"]

  def set_params(self, params: Dict[str, torch.Tensor]) -> None:
    """Copies {'theta': tensor, 'phi': tensor} (see convert.py) into the
    single parameter of the energy and of the circuit."""
    with torch.no_grad():
      for key, value in params.items():
        (param,) = self.params[key]
        param.copy_(value.reshape(param.shape))
