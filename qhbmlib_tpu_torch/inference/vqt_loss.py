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

from qhbmlib_tpu_torch.inference import estimators
from qhbmlib_tpu_torch.inference import qhbm as qhbm_module
from qhbmlib_tpu_torch.models import hamiltonian as hamiltonian_model
from qhbmlib_tpu_torch.ops import paulis


def _f_vqt(input_qhbm: qhbm_module.QHBM, target):
  """f(beta, bits) = beta*<H>_{U|x>} - no_grad(E(x)) per support
  bitstring."""
  e_inf = input_qhbm.e_inference
  q_inf = input_qhbm.q_inference

  def f_vqt(beta, bits):
    h_exp = q_inf.expectation(bits, target, dedup=False)[:, 0]
    with torch.no_grad():
      energies = e_inf.energy(bits)
    return beta * h_exp - energies

  return f_vqt


def make_vqt(input_qhbm: qhbm_module.QHBM,
             target: Union[paulis.PauliSum, hamiltonian_model.Hamiltonian]):
  """Builds the VQT loss of a (qhbm, target) pair.

  Returns loss_fn(beta, generator=None) -> scalar loss tensor on the model's
  device.  It reads the models' current parameters; `loss.backward()` fills
  their `.grad`.  `generator` overrides the EBM's sampling generator.
  """
  e_inf = input_qhbm.e_inference
  f_vqt = _f_vqt(input_qhbm, target)

  def loss_fn(beta, generator: Optional[torch.Generator] = None):
    avg = e_inf.expectation(lambda bits: f_vqt(beta, bits), generator)
    with torch.no_grad():
      log_z = e_inf.log_partition_forward(generator)
    return avg - log_z

  return loss_fn


def make_vqt_with_state(input_qhbm: qhbm_module.QHBM,
                        target: Union[paulis.PauliSum,
                                      hamiltonian_model.Hamiltonian]):
  """The VQT loss of a train step that threads the EBM sampler's state, as
  the reference's jitted step does (`make_vqt`'s pure loss with
  `ebm_state`, vqt_loss.py:61-87): no burn-in, whatever the parameters.

  Returns loss_fn(beta, generator=None, state=None) -> (loss, new state).
  A chain state (GWG) is advanced by the support of <f_vqt>, then once
  more by the support drawn for log Z, as the reference's two threaded
  calls; a stateless sampler (state None) draws once, as `make_vqt`."""
  e_inf = input_qhbm.e_inference
  f_vqt = _f_vqt(input_qhbm, target)

  def loss_fn(beta, generator: Optional[torch.Generator] = None, state=None):
    support, counts, new_state = e_inf.support_counts_state(generator, state)
    avg = estimators.sampled_expectation(
        e_inf.energy, e_inf.theta, f_vqt(beta, support.to(torch.int8)),
        support, counts)
    if new_state is not None:
      _, _, new_state = e_inf.support_counts_state(generator, new_state)
    with torch.no_grad():
      log_z = e_inf.log_partition_forward(generator)
    return avg - log_z, new_state

  return loss_fn


def vqt(input_qhbm: qhbm_module.QHBM,
        target: Union[paulis.PauliSum, hamiltonian_model.Hamiltonian],
        beta, generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """The VQT loss's value at the models' current parameters (reference
  `vqt_loss.py:92`); for gradients, call `make_vqt`'s loss and
  `backward()`."""
  with torch.no_grad():
    return make_vqt(input_qhbm, target)(beta, generator)
