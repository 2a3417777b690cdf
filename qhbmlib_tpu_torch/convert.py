"""Carries JAX parameter trees into the port's modules.

`from_jax_params` takes a parameter tree of the JAX package (numpy or jax
arrays) and returns the same tree of float32 torch tensors, each group of
one array becoming one tensor and a group of several a tuple of tensors:

  * a QHBM's ``{'theta': [array], 'phi': [array]}`` for `QHBM.set_params`;
  * a Hamiltonian's ``{'energy': [array], 'circuit': [array]}`` for
    `Hamiltonian.set_params`;
  * nested trees of those, e.g. a QMHL's ``{'model': {...}, 'data': {...}}``
    or a Hamiltonian VQT target's ``{'target_energy': [...],
    'target_circuit': [...]}`` beside ``theta`` and ``phi``.

Both packages use the same parameter order: the energy's kernel per bit,
the circuit's symbols sorted by name (DirectQuantumCircuit), or QAIA's
three arrays [etas, thetas, gammas] in the reference's
`trainable_variables` order (`models/circuit.py:89-95`).  Nothing here
imports jax: the arrays are read through numpy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib


def from_jax_params(params: Mapping, device=None):
  """A tree of mappings and groups -> the same tree of tensors.

  A mapping maps each value; a list or tuple is a group: one array becomes
  one tensor (BernoulliEnergy, DirectQuantumCircuit), several a tuple of
  tensors in the group's order (QAIA); a bare array is taken as it is.
  The tensors land on `device` (None means the CUDA card,
  `device.resolve`)."""
  device = device_lib.resolve(device)

  def tensor(value):
    return torch.tensor(np.asarray(value, np.float32), device=device)

  def convert(key, value):
    if isinstance(value, Mapping):
      return {k: convert(k, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
      if not value:
        raise ValueError(f"params[{key!r}] is an empty group")
      if len(value) > 1:
        return tuple(tensor(v) for v in value)
      value = value[0]
    return tensor(value)

  return {k: convert(k, v) for k, v in params.items()}
