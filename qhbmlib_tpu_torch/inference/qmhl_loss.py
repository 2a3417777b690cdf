"""QMHL loss: the quantum cross-entropy <K_model>_data + log Z_model (port
of `qhbmlib_tpu/inference/qmhl_loss.py`).

K_model is the model QHBM's modular Hamiltonian U_phi E_theta U_phi^dagger;
its expectation against the data is the data's own estimator (for QHBMData,
the data QHBM's eq. A5 average of <K_model> over its circuit's states), and
log Z carries the eq. C2 gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from qhbmlib_tpu_torch.data import quantum_data
from qhbmlib_tpu_torch.inference import qhbm as qhbm_module


def make_qmhl(data: quantum_data.QuantumData, input_qhbm: qhbm_module.QHBM):
  """Builds the QMHL loss of a (data, model) pair.

  Returns loss_fn(generators=None) -> scalar loss tensor.  It reads the
  current parameters; `loss.backward()` fills the model's `.grad` and also
  the data's (train only the model's: the reference differentiates
  `params["model"]` alone).  `generators`, a (data, model) pair, overrides
  the generators the data's expectation and the model's log Z draw from.
  """
  model_k = input_qhbm.modular_hamiltonian
  e_inf = input_qhbm.e_inference

  def loss_fn(generators: Optional[Sequence[torch.Generator]] = None):
    data_gen, model_gen = generators or (None, None)
    return data.expectation(model_k, data_gen) + e_inf.log_partition(model_gen)

  return loss_fn


def make_qmhl_with_state(data: quantum_data.QuantumData,
                         input_qhbm: qhbm_module.QHBM):
  """The QMHL loss of a train step that threads the model sampler's state,
  as the reference's jitted step does (`make_qmhl`'s pure loss with
  `ebm_state`, qmhl_loss.py:30-46): no burn-in, whatever the parameters.

  Returns loss_fn(generators=None, model_state=None) -> (loss, new model
  state): `model_state` is the model EBM's sampler state (a GWG chain
  state; None continues the stored one) and log Z draws its support, then
  its Monte Carlo samples, from the model's generator.  The data's
  expectation uses its own sampler as `make_qmhl` does."""
  model_k = input_qhbm.modular_hamiltonian
  e_inf = input_qhbm.e_inference

  def loss_fn(generators: Optional[Sequence[torch.Generator]] = None,
              model_state=None):
    data_gen, model_gen = generators or (None, None)
    data_exp = data.expectation(model_k, data_gen)
    log_z, new_state = e_inf.log_partition_with_state(model_gen, model_state)
    return data_exp + log_z, new_state

  return loss_fn
