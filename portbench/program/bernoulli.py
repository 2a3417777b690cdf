"""The port's Bernoulli energy and its sampler (deduplicated draws)."""

from __future__ import annotations

from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn as port_nn
from qhbmlib_tpu_torch.inference import ebm


def build(config, traffic, device):
  """(energy, its inference): `traffic["samples"]` draws a step, at most
  `traffic["max_unique"]` distinct rows kept."""
  n = config["qubits"]
  energy = models.BernoulliEnergy(list(range(n)),
                                  initializer=port_nn.Constant(0.0),
                                  device=device)
  inference = ebm.BernoulliEnergyInference(
      energy, traffic["samples"], initial_seed=0,
      max_unique_samples=traffic["max_unique"], device=device)
  return energy, inference
