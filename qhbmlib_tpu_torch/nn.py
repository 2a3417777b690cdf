"""Initializers for the port's nn.Modules.

Port of the initializers in `qhbmlib_tpu/nn.py`.  Each draws from an
explicit `torch.Generator` (a fresh one seeded from `seed` when none is
given), so a model built from a seed is reproducible.  Layers themselves
are plain `torch.nn.Module`s with `nn.Parameter`s (models/).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class Initializer:
  """Callable (shape, device) -> float32 tensor."""

  def __call__(self, shape: Sequence[int], device=None) -> torch.Tensor:
    raise NotImplementedError()


def _generator(generator: Optional[torch.Generator],
               seed: Optional[int]) -> torch.Generator:
  if generator is not None:
    return generator
  g = torch.Generator()
  if seed is None:
    g.seed()
  else:
    g.manual_seed(seed)
  return g


class RandomUniform(Initializer):
  """U[minval, maxval), drawn on the generator's device (the CPU unless a
  CUDA generator is passed) and moved to `device`."""

  def __init__(self, minval=-0.05, maxval=0.05, seed: Optional[int] = None,
               generator: Optional[torch.Generator] = None):
    self.minval = minval
    self.maxval = maxval
    self.generator = _generator(generator, seed)

  def __call__(self, shape, device=None):
    u = torch.rand(tuple(shape), generator=self.generator,
                   device=self.generator.device, dtype=torch.float32)
    return (self.minval + (self.maxval - self.minval) * u).to(device)


class Constant(Initializer):

  def __init__(self, value=0.0):
    self.value = value

  def __call__(self, shape, device=None):
    return torch.full(tuple(shape), self.value, dtype=torch.float32,
                      device=device)

