"""What a run feeds the program, all of it from `--seed`: the model's
initial weights, and the generator the EBM draws its samples from.

A cell's traffic is data (`workloads/<cell>.json`, key "traffic"): the
loss and its beta, draws a step and distinct rows kept, Adam's learning
rate and the steps traced.  Every seed gives the same sizes; only
the weights and the draws differ, so a step does the same work whatever
the seed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import vqt as reference_vqt


def seeds(seed: int) -> Dict[str, int]:
  """Independent 63-bit seeds of the weights and of the draws, from any
  whole number."""
  weights, draws = np.random.SeedSequence(int(seed)).generate_state(
      2, dtype=np.uint64) >> np.uint64(1)
  return {"weights": int(weights), "draws": int(draws)}


def _draw(init, shape, gen: torch.Generator) -> torch.Tensor:
  (law, (a, b)), = init.items()
  if law == "uniform":
    u = torch.rand(shape, generator=gen, device=gen.device)
    return a + (b - a) * u
  if law == "normal":
    return a + b * torch.randn(shape, generator=gen, device=gen.device)
  raise ValueError(f"unknown initializer {law!r}")


def make_weights(config, seed: int, device) -> List[Tuple[str, torch.Tensor]]:
  """[(name, float32 tensor on `device`)] of every parameter in the
  optimizer's order, drawn on the device by one generator seeded from
  `seed`: the energy's leaves from config["energy"]["init"], the
  circuit's from config["circuit"]["init"] ({"uniform": [lo, hi]} or
  {"normal": [mean, stddev]})."""
  gen = torch.Generator(device=device)
  gen.manual_seed(seeds(seed)["weights"])
  out = []
  for part in ("energy", "circuit"):
    module = reference_vqt.kind(config[part]["kind"])
    for name, shape in module.leaf_shapes(config):
      out.append((name, _draw(config[part]["init"], shape, gen)))
  return out


def draw_generator(seed: int, device) -> torch.Generator:
  """The generator the EBM draws every step's samples from."""
  gen = torch.Generator(device=device)
  gen.manual_seed(seeds(seed)["draws"])
  return gen
