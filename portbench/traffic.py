"""What a run feeds the program, all of it from `--seed`: the initial
weights of every part the cell's loss draws, and the generator the EBM
draws its samples from.

A cell's traffic is data (`workloads/<cell>.json`, key "traffic"): the
loss and its beta, draws a step and distinct rows kept, Adam's learning
rate and the steps traced.  The loss's reference lists the parts whose
weights are drawn (`reference/<loss>.py`, `parts`): the model's energy
and circuit, and any fixed part it has besides (a loss's data).  Every
seed gives the same sizes; only the weights and the draws differ, so a
step does the same work whatever the seed.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import numpy as np
import torch


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


def _reference(name: str):
  return importlib.import_module(f"portbench.reference.{name}")


def make_weights(config, loss: str, seed: int,
                 device) -> List[Tuple[str, torch.Tensor]]:
  """[(name, float32 tensor on `device`)] of every leaf of every part that
  the reference of `loss` lists (`parts(config)`: [(the part's own
  configuration, its key there, the prefix of its leaf names)]), part by
  part in that order, drawn on the device by one generator seeded from
  `seed`.  A part's leaves are its kind's (`reference/<kind>.py`,
  `leaf_shapes`), each drawn from the part's "init" ({"uniform": [lo,
  hi]} or {"normal": [mean, stddev]})."""
  gen = torch.Generator(device=device)
  gen.manual_seed(seeds(seed)["weights"])
  out = []
  for part_config, part, prefix in _reference(loss).parts(config):
    spec = part_config[part]
    for name, shape in _reference(spec["kind"]).leaf_shapes(part_config):
      out.append((prefix + name, _draw(spec["init"], shape, gen)))
  if len({name for name, _ in out}) != len(out):
    raise ValueError(f"{loss}: two drawn leaves share a name")
  return out


def draw_generator(seed: int, device) -> torch.Generator:
  """The generator the EBM draws every step's samples from."""
  gen = torch.Generator(device=device)
  gen.manual_seed(seeds(seed)["draws"])
  return gen
