"""Carries JAX QHBM parameters into the port's modules.

`from_jax_params` takes the JAX package's `QHBM.params`
(``{'theta': [array], 'phi': [array]}``, numpy or jax arrays) and returns
float32 torch tensors keyed the same way; `QHBM.set_params` of the port
copies them into its energy and circuit.  Both use the same parameter order:
the energy's kernel per bit, and the circuit's symbols sorted by name.
Nothing here imports jax: the arrays are read through numpy.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib


def from_jax_params(params: Mapping[str, Sequence],
                    device=None) -> Dict[str, torch.Tensor]:
  """{'theta': [array], 'phi': [array]} -> {'theta': tensor, 'phi': tensor}.

  The tensors land on `device` (None means the CUDA card,
  `device.resolve`).  Raises if a group holds other than exactly one array
  (the port's BernoulliEnergy and DirectQuantumCircuit each have one
  parameter)."""
  device = device_lib.resolve(device)
  out = {}
  for key in ("theta", "phi"):
    group = list(params[key])
    if len(group) != 1:
      raise ValueError(f"params[{key!r}] holds {len(group)} arrays; the port's "
                       "models take exactly one")
    out[key] = torch.tensor(np.asarray(group[0], np.float32), device=device)
  return out
