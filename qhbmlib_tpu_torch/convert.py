"""Carries JAX parameter trees into the port's modules.

`from_jax_params` takes a parameter tree of the JAX package (numpy or jax
arrays) and returns the same tree of float32 torch tensors, each group of
one array becoming one tensor:

  * a QHBM's ``{'theta': [array], 'phi': [array]}`` for `QHBM.set_params`;
  * a Hamiltonian's ``{'energy': [array], 'circuit': [array]}`` for
    `Hamiltonian.set_params`;
  * nested trees of those, e.g. a QMHL's ``{'model': {...}, 'data': {...}}``
    or a Hamiltonian VQT target's ``{'target_energy': [...],
    'target_circuit': [...]}`` beside ``theta`` and ``phi``.

Both packages use the same parameter order: the energy's kernel per bit,
and the circuit's symbols sorted by name.  Nothing here imports jax: the
arrays are read through numpy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib


def from_jax_params(params: Mapping, device=None):
  """A tree of mappings and groups -> the same tree of tensors.

  A mapping maps each value; a list or tuple is a group and must hold
  exactly one array (the port's BernoulliEnergy and DirectQuantumCircuit
  each have one parameter); a bare array is taken as it is.  The tensors
  land on `device` (None means the CUDA card, `device.resolve`)."""
  device = device_lib.resolve(device)

  def convert(key, value):
    if isinstance(value, Mapping):
      return {k: convert(k, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
      if len(value) != 1:
        raise ValueError(f"params[{key!r}] holds {len(value)} arrays; the "
                         "port's models take exactly one")
      value = value[0]
    return torch.tensor(np.asarray(value, np.float32), device=device)

  return {k: convert(k, v) for k, v in params.items()}
