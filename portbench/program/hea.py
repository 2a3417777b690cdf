"""The port's hardware-efficient ansatz (`models.hardware_efficient_ansatz`
in a `DirectQuantumCircuit`)."""

from __future__ import annotations

from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn as port_nn


def build(config, energy, shards, device):
  """The circuit of config["circuit"]["layers"] layers (`energy` and the
  target's `shards` are not used)."""
  del energy, shards
  pqc = models.hardware_efficient_ansatz(config["qubits"],
                                         config["circuit"]["layers"])
  return models.DirectQuantumCircuit(pqc, initializer=port_nn.Constant(0.0),
                                     device=device)
