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
  """The QMHL loss of a train step that threads both sampler states, as
  the reference's jitted step does (`make_qmhl`'s pure loss with the
  (data, model) `ebm_state` pair, qmhl_loss.py:30-46): no burn-in,
  whatever the parameters.

  Returns loss_fn(generators=None, state=None) -> (loss, (new data state,
  new model state)).  `state` is the (data, model) pair of sampler states
  (a GWG chain state, or None: a stateless sampler's, or a chain's stored
  state continued without advancing it).  The data's expectation draws its
  support from the data's generator (`QuantumData.expectation_with_state`);
  log Z its support, then its Monte Carlo samples, from the model's."""
  model_k = input_qhbm.modular_hamiltonian
  e_inf = input_qhbm.e_inference

  def loss_fn(generators: Optional[Sequence[torch.Generator]] = None,
              state=None):
    data_gen, model_gen = generators or (None, None)
    data_state, model_state = state or (None, None)
    data_exp, data_state = data.expectation_with_state(model_k, data_gen,
                                                       data_state)
    log_z, model_state = e_inf.log_partition_with_state(model_gen,
                                                        model_state)
    return data_exp + log_z, (data_state, model_state)

  return loss_fn


def qmhl(data: quantum_data.QuantumData, input_qhbm: qhbm_module.QHBM,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """The QMHL loss's value at the current parameters (reference
  `qmhl_loss.py:49`); `generator` overrides the model's log Z draw.  For
  gradients, call `make_qmhl`'s loss and `backward()`."""
  with torch.no_grad():
    return make_qmhl(data, input_qhbm)((None, generator))
