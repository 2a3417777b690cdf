"""The port's KOBE energy and its Gibbs-With-Gradients sampler (parallel
chains, deduplicated draws)."""

from __future__ import annotations

from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn as port_nn
from qhbmlib_tpu_torch.inference import ebm


def build(config, traffic, device):
  """(energy, its inference): the KOBE energy of config["energy"]["order"]
  sampled by config["energy"]["sampler"]["chains"] GWG chains,
  `traffic["samples"]` draws a step, at most `traffic["max_unique"]`
  distinct rows kept."""
  n = config["qubits"]
  spec = config["energy"]
  energy = models.KOBE(list(range(n)), spec["order"],
                       initializer=port_nn.Constant(0.0), device=device)
  sampler = spec["sampler"]
  inference = ebm.GibbsWithGradientsInference(
      energy, traffic["samples"], num_burnin_samples=sampler["burn_in"],
      num_chains=sampler["chains"],
      max_unique_samples=traffic["max_unique"], initial_seed=0,
      device=device)
  return energy, inference
