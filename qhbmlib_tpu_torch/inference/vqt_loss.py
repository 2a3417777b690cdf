"""VQT loss: variational free energy beta*<H> - S (port of
`qhbmlib_tpu/inference/vqt_loss.py`):

    f_vqt(x) = beta * <H>_{U|x>} - no_grad(E_theta(x))
    loss     = <f_vqt>_EBM  -  no_grad(log Z)

where <.>_EBM carries the eq. A5 score-function gradient.  The target H is a
PauliSum (whose coefficients get gradients when they require them) or a
Hamiltonian with a Pauli energy (whose circuit and energy parameters get
gradients).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from qhbmlib_tpu_torch.inference import qhbm as qhbm_module
from qhbmlib_tpu_torch.models import hamiltonian as hamiltonian_model
from qhbmlib_tpu_torch.ops import paulis


def make_vqt(input_qhbm: qhbm_module.QHBM,
             target: Union[paulis.PauliSum, hamiltonian_model.Hamiltonian]):
  """Builds the VQT loss of a (qhbm, target) pair.

  Returns loss_fn(beta, generator=None) -> scalar loss tensor on the model's
  device.  It reads the models' current parameters; `loss.backward()` fills
  their `.grad`.  `generator` overrides the EBM's sampling generator.
  """
  e_inf = input_qhbm.e_inference
  q_inf = input_qhbm.q_inference

  def f_vqt(beta, bits):
    """beta*<H>_{U|x>} - no_grad(E(x)) per support bitstring."""
    h_exp = q_inf.expectation(bits, target, dedup=False)[:, 0]
    with torch.no_grad():
      energies = e_inf.energy(bits)
    return beta * h_exp - energies

  def loss_fn(beta, generator: Optional[torch.Generator] = None):
    avg = e_inf.expectation(lambda bits: f_vqt(beta, bits), generator)
    with torch.no_grad():
      log_z = e_inf.log_partition_forward(generator)
    return avg - log_z

  return loss_fn
