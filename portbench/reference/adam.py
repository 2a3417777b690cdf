"""Reference Adam (Kingma and Ba, arXiv:1412.6980, Algorithm 1), in the
form PyTorch documents for `torch.optim.Adam` without weight decay or
amsgrad: m and v the moment averages, the step lr / (1 - b1^t) m over
sqrt(v) / sqrt(1 - b2^t) + eps."""

from __future__ import annotations

import math
from typing import List, Sequence

import torch


class Adam:

  def __init__(self, params: Sequence[torch.Tensor], lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8):
    self.params = list(params)
    self.lr = lr
    self.b1, self.b2 = betas
    self.eps = eps
    self.t = 0
    self.m = [torch.zeros_like(p) for p in self.params]
    self.v = [torch.zeros_like(p) for p in self.params]

  @torch.no_grad()
  def step(self, grads: List[torch.Tensor]) -> None:
    self.t += 1
    bc1 = 1.0 - self.b1**self.t
    bc2 = 1.0 - self.b2**self.t
    for p, g, m, v in zip(self.params, grads, self.m, self.v):
      m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
      v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
      denom = v.sqrt() / math.sqrt(bc2) + self.eps
      p.addcdiv_(m, denom, value=-self.lr / bc1)
