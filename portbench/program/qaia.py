"""The port's QAIA (`models.QAIA`) on the target's letter shards and the
energy's Z shards, as the harness builds it (`baselines/train.py:207-209`
of the reference library)."""

from __future__ import annotations

from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn as port_nn


def build(config, energy, shards, device):
  """QAIA of config["circuit"]["layers"] layers: quantum terms the target's
  PauliSums of one letter each (`shards`), classical terms the energy's
  operator shards."""
  n = config["qubits"]
  return models.QAIA(shards, energy.operator_shards(n),
                     config["circuit"]["layers"],
                     initializer=port_nn.Constant(0.0), device=device)
